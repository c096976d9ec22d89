"""Boolean circuits (scheme 1): one client evaluates the traffic's circuits
in turn through `circuit.evaluate`, each on `instances` instances whose
input bits the seed draws from a pool of encrypted bits; the answers are
the circuit's output batches, on the host."""

from __future__ import annotations

import functools

import numpy as np
import torch

from fhebench.drivers import common
from fhebench.reference import plain


class Driver(common.Driver):
    def __init__(self, *args):
        super().__init__(*args)
        self.kinds = [(name, int(nbits)) for name, nbits in self.traffic["circuits"]]
        self.instances = self.traffic["instances"]
        self.work = {"circuits": 1}

    def setup(self) -> None:
        from sgfhe_tpu_torch import circuit as C

        p = self.params
        s, self.ctx, self.bkey = common.keys(self.T, self.config, p, self.gen)
        self.circuits = [getattr(C, name)(nbits) for name, nbits in self.kinds]
        bits = torch.randint(0, 2, (self.traffic["pool"],), generator=self.gen,
                             device=self.device)
        self.pool = common.encrypt(s, bits, p, self.config["input_noise"], self.gen)
        self.secret, self.bits = s.cpu().numpy(), bits.cpu().numpy()

    def request(self, i: int) -> tuple[int, np.ndarray]:
        """(kind, (2 nbits, instances) pool indices): the kind in turn, the
        inputs a_0.., b_0.. (least significant first) of every instance."""
        kind = i % len(self.kinds)
        nbits = self.kinds[kind][1]
        return kind, self.rng.integers(0, self.bits.size, (2 * nbits, self.instances))

    def warm_requests(self) -> list:
        return [(kind, np.arange(2 * nbits * self.instances).reshape(2 * nbits, -1)
                 % self.bits.size) for kind, (_, nbits) in enumerate(self.kinds)]

    def serve(self, req) -> list:
        from sgfhe_tpu_torch import circuit as C
        from sgfhe_tpu_torch.models.scheme1 import LWE, EncryptedBit

        kind, idx = req
        rows = torch.from_numpy(idx)
        a, b = (x[rows].to(self.device) for x in self.pool)
        inputs = [EncryptedBit(LWE(a[j], b[j])) for j in range(idx.shape[0])]
        if not self.prune:
            outs = C.evaluate(self.circuits[kind], self.params, self.ctx, self.bkey, inputs,
                              self.words)
            return common.to_host([o.lwe for o in outs])
        # circuit.evaluate takes no prune: a pruned control passes it to each
        # level's bootstrap_internal
        from sgfhe_tpu_torch.models import bootstrap as bs

        whole = bs.bootstrap_internal
        bs.bootstrap_internal = functools.partial(whole, prune=self.prune)
        try:
            outs = C.evaluate(self.circuits[kind], self.params, self.ctx, self.bkey, inputs,
                              self.words)
        finally:
            bs.bootstrap_internal = whole
        return common.to_host([o.lwe for o in outs])

    def expected(self, req) -> list:
        kind, idx = req
        name, nbits = self.kinds[kind]
        return plain.CIRCUITS[name](self.bits[idx[:nbits]], self.bits[idx[nbits:]])
