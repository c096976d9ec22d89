"""What every driver shares: the port's parameters held against the
configuration, the random streams of a seed, the secret key and the pools
of encrypted inputs.

The benchmark makes the secret key and encrypts the inputs itself, with
plain LWE encryption on the card: a uniform in Z_r^n, noise uniform in
[-bound, bound] (the configuration's `input_noise`), b = <a, s> + noise +
message * Dr mod r. The port receives the secret key to build its
bootstrap key from, and the ciphertexts; the reference receives the secret
key and the messages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_U64 = (1 << 64) - 1


def program():
    """The system under test."""
    import sgfhe_tpu_torch

    return sgfhe_tpu_torch


def scheme_params(T, config: dict, control: dict | None = None):
    """The port's Params for the configuration, every number the
    configuration states held against it. A control (readings.py) of
    {"limbs": N} keeps the first N of the big modulus's primes."""
    if config["scheme"] == 1:
        params = T.Params.create(config["n"])
    elif config["scheme"] == 2:
        params = T.Scheme2.Params.create(config["k"], config["n"])
    else:
        raise ValueError(f"no scheme {config['scheme']!r}")
    for key, want in config.get("params", {}).items():
        got = getattr(params, key)
        if (list(got) if isinstance(got, tuple) else got) != want:
            raise RuntimeError(f"the port's {key} is {got}; the configuration states {want}")
    if control and "limbs" in control:
        params = dataclasses.replace(params, moduli=params.moduli[:control["limbs"]])
    return params


def streams(seed: int, device) -> tuple[torch.Generator, np.random.Generator]:
    """The seed's two streams: one on the card for keys, messages and
    encryptions, one on the host for the draws of each request."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & _U64)
    return gen, np.random.default_rng([seed & _U64, 1])


def seed_words(rng: np.random.Generator) -> tuple[int, int]:
    """The two uint32 words of randomized flattening."""
    lo, hi = rng.integers(0, 1 << 32, 2, dtype=np.uint64)
    return int(lo), int(hi)


def keys(T, config: dict, params, gen: torch.Generator):
    """(secret key (n,) int64 on the card, the port's context, its bootstrap
    key made from the secret key on the card)."""
    dev = gen.device
    s = torch.randint(0, 2, (params.n,), generator=gen, device=dev, dtype=torch.int64)
    S = T if config["scheme"] == 1 else T.Scheme2
    ctx = S.make_context(params, device=dev)
    return s, ctx, S.BootstrapKey.create(ctx, S.PrivateKey(params, s), gen)


def encrypt(s: torch.Tensor, messages: torch.Tensor, params, bound: int,
            gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """LWE encryptions of `messages` (N,) under s, made on the card, handed
    back on the host: a (N, n), b (N,) int64 mod r."""
    dev = s.device
    N, n, r = messages.shape[0], params.n, params.r
    a = torch.randint(0, r, (N, n), generator=gen, device=dev, dtype=torch.int64)
    e = torch.randint(-bound, bound + 1, (N,), generator=gen, device=dev, dtype=torch.int64)
    b = ((a * s).sum(-1) + e + messages.to(torch.int64) * params.Dr) % r
    return a.cpu(), b.cpu()


class Driver:
    """What every driver keeps: the port, its Params, the gadget digits it
    prunes, the seed's streams and the seed words of randomized mode. A
    driver adds `work` (units of work a request), `setup`, `request(i)`,
    `warm_requests`, `serve(req)` (the answers on the host) and
    `expected(req)` (the reference's messages, in the answers' order)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: dict | None = None):
        self.T = program()
        self.config, self.traffic, self.device = config, traffic, device
        self.params = scheme_params(self.T, config, control)
        self.prune = (control or {}).get("prune", config["prune"])
        self.gen, self.rng = streams(seed, device)
        self.words = seed_words(self.rng) if traffic["mode"] == "randomized" else None

    def close(self) -> None:
        """Free the port's state on the card."""
        del self.ctx, self.bkey


def to_host(lwes) -> list:
    """Each LWE answer batch as (a, b) host tensors: the server's reply."""
    return [(x.a.cpu(), x.b.cpu()) for x in lwes]
