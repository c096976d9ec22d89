"""Drive sgfhe_tpu_torch's main path on one NVIDIA card and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero:
  1. the card's name and power limit; build the kernels from csrc/.
  2. kernels vs twin on the card, bit for bit, at Params(64) with port-made
     keys: exact (carry and w-multiply T-modes), prune 1 and 2, randomized,
     and near-2^29 moduli with l = 3.
  2b. one step of each kernel against its plain version, bit for bit, at
     L in {2, 3, 4} x m in {512, 4096, 8192, 32768} with near-2^29 moduli,
     random canonical inputs and key slice, B = 1 and a batch whose last
     gate tile is partial, every prune, exact and randomized, every T-mode.
  3. each kernel against its plain version at the main path's shapes, in
     both of its modes, with its time (steps 0..n-1 in turn, as the main
     path walks the key), the plain version's time and its bound.
  4. main path at Params(64): keygen, encrypt, split, bootstrap_batch on
     4096 gates, decrypt_bit, AND/OR/XOR truth tables, gates/s, and a
     profiler trace of one call (device busy and idle time, each kernel's
     own device time).
  5. main path at Params(512), full width (576 MiB key): 256 gates, truth
     tables, gates/s, launches == 2n per call, the trace, the twin's time on
     the card for the same batch and its equality with the kernels' output.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# NVIDIA's H100 SXM data sheet gives 67 TFLOP/s float32, an FMA counted as 2
# operations on 128 lanes per SM; Hopper has 64 int32 multiply-add lanes per
# SM, so int32 multiplies run at a quarter of that rate.
INT32_MUL_PER_S = 67e12 / 4
SHOUP_MULS = 3  # a*w, mulhi(a, w'), q*p
SEED2 = (0x12345678, 0x9ABCDEF0)


def fail(msg: str):
    raise RuntimeError(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn(0), ..., fn(reps - 1) by CUDA events, after fn(0)."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(bytes_moved: float, muls: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT32_MUL_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fwd_cost(B, L, m, lk, randomized):
    """Bytes and int32 multiplies one flatten_ntt_fwd launch needs: the
    digit chain (and in randomized mode the masks) once per coefficient,
    one forward NTT per (gate, operand, kept digit, limb)."""
    logm = m.bit_length() - 1
    nbytes = 2 * B * L * m * 4 + B * 2 * lk * L * m * 4 + L * 2 * m * 4
    coeffs = 2 * B * m
    chain = L * (L - 1) // 2 * SHOUP_MULS  # digit d takes d Shoup steps
    masks = lk * L * (1 + SHOUP_MULS) if randomized else 0  # v % p_j, times w
    ntt = B * 2 * lk * L * (m // 2) * logm * SHOUP_MULS
    return nbytes, coeffs * (chain + masks) + ntt


def mac_cost(B, L, m, lk, t_mode):
    """Bytes and int32 multiplies one mac_rotate_ntt_inv launch needs."""
    logm = m.bit_length() - 1
    acc = 2 * B * L * m * 4
    nbytes = (B * 2 * lk * L * m * 4 + 2 * (2 * lk * 2 * L * m * 4) + B * 4 + acc
              + L * 8 * m * 4 + (2 * acc if t_mode == 2 else acc if t_mode == 1 else 0))
    per_elem = 2 * lk + (0 if t_mode == 2 else lk) + 1 + 1
    muls = 2 * B * L * (m * per_elem + (m // 2) * logm)
    return nbytes, muls * SHOUP_MULS


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "sgfhe_tpu_torch" / "csrc" / "rotate.cu").is_file():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import sgfhe_tpu_torch as T
    from sgfhe_tpu_torch import _build
    from sgfhe_tpu_torch.models import bootstrap as tbs
    from sgfhe_tpu_torch.ops import fused
    from sgfhe_tpu_torch.ops import modmath as mm
    from sgfhe_tpu_torch.utils import primes

    dev = torch.device("cuda")
    card = smi()
    print(f"[1] card: {card}")
    print(f"[1] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s")

    def reset():
        fused.flatten_ntt_fwd.launches = 0
        fused.mac_rotate_ntt_inv.launches = 0

    def counts():
        return fused.flatten_ntt_fwd.launches, fused.mac_rotate_ntt_inv.launches

    def keys(params, seed, ctx=None):
        ctx = ctx or T.make_context(params, device=dev)
        g = torch.Generator().manual_seed(seed)
        sk = T.PrivateKey.create(params, g, device=dev)
        return ctx, sk, T.BootstrapKey.create(ctx, sk, g), g

    def rand_acc(params, B, seed):
        gen = torch.Generator().manual_seed(seed)
        L, m = params.num_limbs, params.m
        p = torch.tensor(params.moduli).reshape(L, 1)
        ua = torch.randint(0, 2 * m, (B, params.n), generator=gen)
        a0 = torch.randint(0, 1 << 30, (B, L, m), generator=gen) % p
        b0 = torch.randint(0, 1 << 30, (B, L, m), generator=gen) % p
        return ua.to(dev), a0.to(dev), b0.to(dev)

    # ---- 2. kernels vs twin, every mode --------------------------------------
    p64 = T.Params.create(64)
    ctx64, sk64, bk64, g64 = keys(p64, 1)
    mods = primes.find_rns_primes(2 * p64.m, 1 << 86, (1 << 87) - 1, 3)
    if not 12 * max(mods) > (1 << 32):
        fail("synthetic moduli do not reach the reset regime")
    p_big = dataclasses.replace(p64, moduli=mods)
    ctx_big, _, bk_big, _ = keys(p_big, 2)
    cases = [
        ("exact carry", p64, ctx64, bk64, 0, None, True),
        ("exact w-multiply", p64, ctx64, bk64, 0, None, False),
        ("prune=1", p64, ctx64, bk64, 1, None, False),
        ("prune=2", p64, ctx64, bk64, 2, None, False),
        ("randomized carry", p64, ctx64, bk64, 0, (0x12345678, 0x9ABCDEF0), True),
        ("randomized prune=1", p64, ctx64, bk64, 1, (0x12345678, 0x9ABCDEF0), False),
        ("near-2^29 l=3 carry", p_big, ctx_big, bk_big, 0, None, True),
        ("near-2^29 l=3 w-multiply", p_big, ctx_big, bk_big, 0, None, False),
    ]
    reset()
    for name, params, ctx, bk, prune, seed2, carry in cases:
        ua, a0, b0 = rand_acc(params, 8, 3)
        want = tbs.blind_rotate(params, ctx, bk.hat, bk.hat_shoup, ua, a0, b0,
                                seed2, prune, plain=True)
        got = fused.blind_rotate_steps(ctx, bk.hat, bk.hat_shoup, ua, a0, b0,
                                       seed2, prune, carry=carry)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            if not torch.equal(w, g):
                fail(f"kernel != twin in mode {name}: "
                     f"{int((w != g).sum())} of {w.numel()} words differ")
        print(f"[2] kernel == twin bit for bit: {name}")
    print(f"[2] launches (flatten_ntt_fwd, mac_rotate_ntt_inv): {counts()}")

    # ---- 2b. one step of each kernel at every supported shape ---------------
    t0 = time.perf_counter()
    n_checks = 0
    for L in (2, 3, 4):
        for m in (512, 4096, 8192, 32768):
            mods = primes.find_rns_primes(2 * m, 1 << (29 * L - 2), (1 << (29 * L - 1)) - 1, L)
            params = dataclasses.replace(T.Params.create(m // 8), moduli=mods)
            ctx = T.make_context(params, device=dev)
            rng = np.random.default_rng(L * m)
            p = np.array(mods, dtype=np.int64).reshape(L, 1)

            def canon(shape):
                return rng.integers(0, 1 << 30, shape) % p

            def on_card(a):
                return mm.bits32(torch.as_tensor(a, device=dev))

            key = canon((1, 2 * L, 2, L, m))
            key_hat, key_s = on_card(key), on_card((key << 32) // p)
            for prune in range(L):
                ragged = next((B for B in range(2, 200)
                               if (g := fused.mac_plan(B, L, m, prune).gates) > 1 and B % g), 2)
                for B in (1, ragged):
                    acc = on_card(canon((2, B, L, m)))
                    u = on_card(rng.integers(0, 2 * m, (B,)))
                    for seed2 in (None, SEED2):
                        got = fused.flatten_ntt_fwd(ctx, acc, 3, seed2, prune)
                        d_p = fused.flatten_ntt_fwd_plain(ctx, acc, 3, seed2, prune)
                        if not torch.equal(got, d_p):
                            fail(f"flatten_ntt_fwd != plain: L={L} m={m} B={B} "
                                 f"prune={prune} randomized={seed2 is not None}")
                        n_checks += 1
                    for t_mode in ((0, 1, 2) if prune == 0 else (0,)):
                        carry_k = on_card(canon((2, B, L, m))) if t_mode else None
                        carry_p = carry_k.clone() if t_mode else None
                        got = fused.mac_rotate_ntt_inv(ctx, d_p, key_hat, key_s, 0, u,
                                                       prune, t_mode, carry_k)
                        want = fused.mac_rotate_ntt_inv_plain(ctx, d_p, key_hat, key_s, 0, u,
                                                              prune, t_mode, carry_p)
                        if not (torch.equal(got, want)
                                and (not t_mode or torch.equal(carry_k, carry_p))):
                            fail(f"mac_rotate_ntt_inv != plain: L={L} m={m} B={B} "
                                 f"prune={prune} t_mode={t_mode}")
                        n_checks += 1
            print(f"[2b] L={L} m={m}: both kernels == plain bit for bit "
                  f"(B = 1 and {ragged}, every prune and mode)")
    torch.cuda.synchronize()
    print(f"[2b] {n_checks} single-step checks in {time.perf_counter() - t0:.1f} s")

    # ---- 3. each kernel against its plain version at main-path shapes -------
    p512 = T.Params.create(512)
    ctx512, sk512, bk512, g512 = keys(p512, 4)
    key_mib = 2 * bk512.hat.numel() * 4 / 2**20
    print(f"[3] Params(512) key with Shoup companions on the card: {key_mib:.0f} MiB")
    table = []
    # (tag, ..., batch, the main path's T-mode, the TPU kernel replaced:
    # _rotate_kernel at Params(64), whose T-term is carried;
    # _rotate_step_kernel at Params(512))
    shapes = [
        ("n=64", p64, ctx64, bk64, 4096, 2, "sgfhe_tpu/ops/fused.py:542"),
        ("n=512", p512, ctx512, bk512, 256, 0, "sgfhe_tpu/ops/fused.py:604"),
    ]

    def add_row(name, replaces, err, ms, pms, nbytes_muls):
        bms, by = bound(*nbytes_muls)
        table.append(dict(
            name=name, route="cuda", source="sgfhe_tpu_torch/csrc/rotate.cu",
            replaces=replaces, launches=0, max_abs_err=err, ms=ms,
            plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=None,
        ))
        print(f"[3] {name}: {ms:.4f} ms/launch ({ms / bms:.1f}x bound), plain "
              f"{pms:.3f} ms, bound {bms:.4f} ms ({by}), max_abs_err {err}")

    for tag, params, ctx, bk, B, main_t, replaces in shapes:
        L, m, n = params.num_limbs, params.m, params.n
        ua, a0, b0 = rand_acc(params, B, 5)
        acc = torch.stack([a0, b0]).to(torch.int32).contiguous()
        u = ua[:, 0].to(torch.int32).contiguous()
        print(f"[3] {tag}: B={B}, plans {fused.fwd_plan(B, L, m, 0, fused._sm_count(0))}, "
              f"{fused.mac_plan(B, L, m, 0, fused._sm_count(0))}")
        d_k = None
        for seed2 in (None, SEED2):
            got = fused.flatten_ntt_fwd(ctx, acc, 0, seed2)
            want = fused.flatten_ntt_fwd_plain(ctx, acc, 0, seed2)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if err:
                fail(f"{tag}: flatten_ntt_fwd vs plain max_abs_err {err}")
            d_k = got if seed2 is None else d_k
            ms = cuda_ms(lambda i: fused.flatten_ntt_fwd(ctx, acc, i % n, seed2), n)
            pms = cuda_ms(lambda i: fused.flatten_ntt_fwd_plain(ctx, acc, i % n, seed2), 3)
            name = f"flatten_ntt_fwd{' randomized' if seed2 else ''} ({tag})"
            add_row(name, replaces, err, ms, pms, fwd_cost(B, L, m, L, seed2 is not None))
        for t_mode in (main_t, 2 - main_t):
            carry_k = torch.stack([b0, a0]).to(torch.int32).contiguous() if t_mode else None
            carry_p = carry_k.clone() if t_mode else None
            out_k = fused.mac_rotate_ntt_inv(ctx, d_k, bk.hat, bk.hat_shoup, 0, u, 0,
                                             t_mode, carry_k)
            out_p = fused.mac_rotate_ntt_inv_plain(ctx, d_k, bk.hat, bk.hat_shoup, 0, u, 0,
                                                   t_mode, carry_p)
            torch.cuda.synchronize()
            err = int((out_k.long() - out_p.long()).abs().max())
            if t_mode:
                err = max(err, int((carry_k.long() - carry_p.long()).abs().max()))
            if err:
                fail(f"{tag}: mac_rotate_ntt_inv t_mode {t_mode} vs plain max_abs_err {err}")
            ms = cuda_ms(lambda i: fused.mac_rotate_ntt_inv(
                ctx, d_k, bk.hat, bk.hat_shoup, i % n, u, 0, t_mode, carry_k), n)
            pms = cuda_ms(lambda i: fused.mac_rotate_ntt_inv_plain(
                ctx, d_k, bk.hat, bk.hat_shoup, i % n, u, 0, t_mode, carry_p), 3)
            name = f"mac_rotate_ntt_inv {'carry' if t_mode else 'w-multiply'} ({tag})"
            add_row(name, replaces, err, ms, pms, mac_cost(B, L, m, L, t_mode))

    # ---- 4/5. the main path --------------------------------------------------
    def truth_tables(sk, out, y1, y2):
        for gate, lwe, want in zip(("AND", "OR", "XOR"), out, (y1 & y2, y1 | y2, y1 ^ y2)):
            got = T.decrypt_bit(sk, T.EncryptedBit(lwe))
            if got.shape != want.shape or not torch.equal(got, want):
                fail(f"{gate} truth table: {int((got != want).sum())} wrong gates")
            if not (lwe.a.max() < sk.params.r and lwe.a.min() >= 0):
                fail(f"{gate}: output out of range")

    def drive(tag, params, ctx, bk, sk, lwe1, lwe2, y1, y2, reps):
        B = lwe1.a.shape[0]
        reset()
        times = []
        for i in range(reps + 1):  # the first run warms up
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = T.bootstrap_batch(params, ctx, bk.hat, bk.hat_shoup, lwe1, lwe2)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t)
        launches = counts()
        truth_tables(sk, out, y1, y2)
        want = params.n * (reps + 1)
        if launches != (want, want):
            fail(f"{tag}: launches {launches}, expected 2n per call = {want} each")
        med = sorted(times)[len(times) // 2]
        print(f"[{tag}] {B} gates, truth tables AND/OR/XOR hold; launches "
              f"(flatten_ntt_fwd, mac_rotate_ntt_inv) = {launches} over {reps + 1} calls")
        print(f"[{tag}] {B / med:.1f} gates/s (median of {reps}: "
              f"{[round(t, 4) for t in times]} s) on {card}")
        per_kernel = trace(tag, lambda: T.bootstrap_batch(params, ctx, bk.hat, bk.hat_shoup,
                                                          lwe1, lwe2))
        return out, launches, per_kernel

    def trace(tag, call):
        """Device busy time of one traced call, by the profiler's device
        events: each rotation kernel, the other device ops, and idle.
        Returns each rotation kernel's device ms per launch."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        busy = 0.0
        kern = {"flatten_ntt_fwd": [0.0, 0], "mac_rotate_ntt_inv": [0.0, 0]}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
                continue
            busy += e.self_device_time_total / 1e3
            for name, acc in kern.items():
                if f"{name}_kernel" in e.key:
                    acc[0] += e.self_device_time_total / 1e3
                    acc[1] += e.count
        rot = sum(ms for ms, _ in kern.values())
        if not all(n for _, n in kern.values()):
            fail(f"[{tag}] the trace misses a rotation kernel on the device: {kern}")
        print(f"[{tag}] trace of one call: {wall:.2f} ms wall, device busy {busy:.2f} ms "
              f"({busy / wall:.1%}): rotation kernels {rot:.2f} ms, other device ops "
              f"{busy - rot:.2f} ms; idle {wall - busy:.2f} ms ({1 - busy / wall:.1%})")
        for name, (ms, n) in kern.items():
            print(f"[{tag}] trace: {name} {ms:.2f} ms over {n} launches "
                  f"({ms / n:.4f} ms/launch)")
        return {name: ms / n for name, (ms, n) in kern.items()}

    # Params(64): every pair (i, j) of two 64-bit messages -> 4096 gates
    m1 = torch.randint(0, 2, (p64.n,), generator=g64)
    m2 = torch.randint(0, 2, (p64.n,), generator=g64)
    e1 = T.split_ciphertext(T.encrypt(sk64, g64, m1)).lwe
    e2 = T.split_ciphertext(T.encrypt(sk64, g64, m2)).lwe
    ii = torch.arange(p64.n, device=dev).repeat_interleave(p64.n)
    jj = torch.arange(p64.n, device=dev).repeat(p64.n)
    lwe1, lwe2 = T.LWE(e1.a[ii], e1.b[ii]), T.LWE(e2.a[jj], e2.b[jj])
    y1, y2 = m1.to(dev)[ii].bool(), m2.to(dev)[jj].bool()
    _, l64, tr64 = drive("4", p64, ctx64, bk64, sk64, lwe1, lwe2, y1, y2, reps=5)

    # Params(512): every pair (2i, 2i+1) of one 512-bit message -> 256 gates
    msg = torch.randint(0, 2, (p512.n,), generator=g512)
    bits = T.split_ciphertext(T.encrypt(sk512, g512, msg)).lwe
    lwe1 = T.LWE(bits.a[0::2], bits.b[0::2])
    lwe2 = T.LWE(bits.a[1::2], bits.b[1::2])
    y1, y2 = msg.to(dev)[0::2].bool(), msg.to(dev)[1::2].bool()
    out, l512, tr512 = drive("5", p512, ctx512, bk512, sk512, lwe1, lwe2, y1, y2, reps=2)
    torch.cuda.synchronize()
    t = time.perf_counter()
    twin = T.bootstrap_batch(p512, ctx512, bk512.hat, bk512.hat_shoup, lwe1, lwe2, plain=True)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t
    for a, b in zip(out, twin):
        if not (torch.equal(a.a, b.a) and torch.equal(a.b, b.b)):
            fail("Params(512): kernel path != twin on the card")
    print(f"[5] twin on the card, same 256 gates: {twin_s:.2f} s "
          f"({256 / twin_s:.1f} gates/s); output equal to the kernels' bit for bit")
    print(f"[5] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # On the rows of the modes the main path runs: launches, the kernel's
    # count in its main-path run, and trace_ms, its device ms per launch in
    # the traced main-path call. The other modes launched 0 times there.
    main_rows = ("flatten_ntt_fwd (n=64)", "mac_rotate_ntt_inv carry (n=64)",
                 "flatten_ntt_fwd (n=512)", "mac_rotate_ntt_inv w-multiply (n=512)")
    for row in table:
        counts_, tr = (l64, tr64) if "(n=64)" in row["name"] else (l512, tr512)
        fwd = row["name"].startswith("flatten")
        main = row["name"] in main_rows
        row["launches"] = (counts_[0] if fwd else counts_[1]) if main else 0
        kname = "flatten_ntt_fwd" if fwd else "mac_rotate_ntt_inv"
        row["trace_ms"] = tr[kname] if main else None
    print(f"[card] {smi()}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
