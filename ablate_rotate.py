"""Time the rotation kernels under every launch plan that fits, on the card.

    python3 ablate_rotate.py [--out FILE]

At the two shapes the step pair's cells run (Params(512), B=256, L=3,
m=4096; scheme 2 at k=4, B=512, L=4, m=16384), exact, times by CUDA
events, steps 0..n-1 in turn, each kernel of csrc/rotate.cu under:
  - its launch plan (ops/fused.py fwd_plan, mac_plan);
  - flatten_ntt_fwd: every other block shape that fits shared memory, down
    to one block per (gate, operand, digit, limb), which reads each
    accumulator and runs the digit chain l x L times;
  - mac_rotate_ntt_inv: every (G, chunk) that fits shared memory: the data
    mac_plan's constants were fitted to (G = 1 stages the key per gate);
  - both: a copy of rotate.cu on RADIX_LOG 1 (one __syncthreads per NTT
    stage), built by nvcc into build/ablation/ and thrown away with it.
Every variant's output is held against the planned kernel's, bit for bit.
Each is timed twice, in forward and then in reverse order. The card's name
and power limit are printed.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def radix2_lib(_build) -> ctypes.CDLL:
    """rotate.cu with one butterfly stage per shared-memory exchange: a copy
    of it beside a copy of rotate_common.cuh with RADIX_LOG 1."""
    header = (_build.CSRC / "rotate_common.cuh").read_text()
    if "#define RADIX_LOG 4\n" not in header:
        raise RuntimeError("rotate_common.cuh no longer defines RADIX_LOG 4")
    out_dir = ROOT / "build" / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "rotate_common.cuh").write_text(
        header.replace("#define RADIX_LOG 4\n", "#define RADIX_LOG 1\n"))
    src, so = out_dir / "rotate_radix2.cu", out_dir / "librotate_radix2.so"
    src.write_text((_build.CSRC / "rotate.cu").read_text())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, args in _build._SIGNATURES["rotate.cu"].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_rotate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import sgfhe_tpu_torch as T
    from sgfhe_tpu_torch import _build
    from sgfhe_tpu_torch.ops import fused
    from sgfhe_tpu_torch.ops import modmath as mm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    libs = {"planned": _build.load(), "radix 2": radix2_lib(_build)}
    stream = torch.cuda.current_stream().cuda_stream
    sms = fused._sm_count(0)

    def ms_of(fn, reps):
        fn(0)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(reps):
            fn(i)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    results = []
    shapes = (("n=512", T.Params.create(512), 256),
              ("s2 k=4", T.Scheme2.Params.create(4), 512))
    for tag, params, B in shapes:
        ft = (T.Scheme2 if hasattr(params, "k") else T).make_context(params, device=dev).fused
        n, L, m = params.n, params.num_limbs, params.m
        g = torch.Generator(device=dev).manual_seed(n)
        pcol = torch.tensor(params.moduli, device=dev).reshape(L, 1)

        def canon(*shape):
            return torch.randint(0, 1 << 30, shape, device=dev, generator=g) % pcol

        key_hat = torch.cat([mm.bits32(canon(1, 2 * L, 2, L, m)) for _ in range(n)])
        acc = mm.bits32(torch.stack([canon(B, L, m), canon(B, L, m)]))
        u = torch.randint(0, 2 * m, (B,), device=dev, generator=g).to(torch.int32)
        d_hat = torch.empty((B, 2 * L, L, m), dtype=torch.int32, device=dev)
        out = torch.empty((2, B, L, m), dtype=torch.int32, device=dev)
        step_bytes = key_hat[0].numel() * 4
        consts = ft.consts.ctypes.data_as(ctypes.c_void_p)

        def fwd(lib, plan, dst):
            words = plan.words().ctypes.data_as(ctypes.c_void_p)

            def run(i):
                rc = lib.sg_flatten_ntt_fwd(
                    acc.data_ptr(), dst.data_ptr(), ft.tables.data_ptr(), consts,
                    B, L, m, 0, int(ft.close), 0, 0, 0, i % n, stream, words)
                assert rc == 0, rc
            return run

        def mac(lib, plan, dst):
            words = plan.words().ctypes.data_as(ctypes.c_void_p)

            def run(i):
                k = i % n
                rc = lib.sg_mac_rotate_ntt_inv(
                    d_hat.data_ptr(), key_hat.data_ptr() + k * step_bytes, u.data_ptr(),
                    dst.data_ptr(), ft.tables.data_ptr(), consts, B, L, m, 0, stream, words)
                assert rc == 0, rc
            return run

        fp = fused.fwd_plan(B, L, m, 0, sms)
        fwd_variants = {"planned": (libs["planned"], fp), "radix 2": (libs["radix 2"], fp)}
        for kl, kd in ((1, L), (1, 1)):
            smem = fused.fwd_smem(kl, kd, m)
            if smem > fused.SMEM_BLOCK or (kl, kd) == (fp.limbs, fp.digits):
                continue
            th = fused._fwd_threads(smem)
            fwd_variants[f"block per {kl} limb(s) x {kd} digit(s)"] = (
                libs["planned"],
                dataclasses.replace(fp, limbs=kl, digits=kd, threads=th, smem=smem,
                                    grid=B * 2 * (L // kl) * (L // kd),
                                    per_sm=fused.blocks_per_sm(smem, th)))
        mp = fused.mac_plan(B, L, m, 0, sms)
        mac_variants = {"planned": (libs["planned"], mp), "radix 2": (libs["radix 2"], mp)}
        for g_ in range(1, 33):
            for c_ in (32, 64, 128, 256, 512, 1024):
                smem = fused.mac_smem(g_, L, m, c_)
                if c_ <= m and g_ * c_ // 4 <= fused.MAC_THREADS and smem <= fused.SMEM_BLOCK:
                    mac_variants[f"G={g_} chunk={c_}"] = (libs["planned"], dataclasses.replace(
                        mp, gates=g_, chunk=c_, smem=smem, grid=2 * L * -(-B // g_),
                        per_sm=fused.blocks_per_sm(smem, fused.MAC_THREADS)))
        for kernel, variants, make in (("flatten_ntt_fwd", fwd_variants, fwd),
                                       ("mac_rotate_ntt_inv", mac_variants, mac)):
            dst = d_hat if kernel == "flatten_ntt_fwd" else out
            ref = None
            for name, (lib, plan) in variants.items():
                res = torch.empty_like(dst)
                make(lib, plan, res)(0)
                torch.cuda.synchronize()
                if ref is None:
                    ref = res
                elif not torch.equal(res, ref):
                    raise RuntimeError(f"{tag} {kernel} {name}: output differs from planned")
            if kernel == "flatten_ntt_fwd":
                d_hat.copy_(ref)
            times = {name: [] for name in variants}
            for names in (list(times), list(times)[::-1]):
                for name in names:
                    times[name].append(ms_of(make(*variants[name], dst), n))
            for name, t in times.items():
                plan = variants[name][1]
                print(f"{tag} {kernel} {name}: {t[0]:.4f} / {t[1]:.4f} ms per launch "
                      f"(mean {sum(t) / 2:.4f}; {plan})")
                results.append(dict(shape=tag, B=B, kernel=kernel, variant=name, ms=t,
                                    plan=dataclasses.asdict(plan)))
            best = min(times, key=lambda k: sum(times[k]))
            print(f"{tag} {kernel}: fastest {best}")
    print(f"card: {card}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
