"""Gate bootstraps (scheme 1): each request is one `bootstrap_batch` call on
`batch` gate pairs drawn by the seed from a pool of encrypted bits; its
answers are the AND, OR and XOR batches, on the host."""

from __future__ import annotations

import numpy as np
import torch

from fhebench.drivers import common
from fhebench.reference import plain


class Driver(common.Driver):
    def __init__(self, *args):
        super().__init__(*args)
        self.batch = self.traffic["batch"]
        self.work = {"gates": self.batch}

    def setup(self) -> None:
        p = self.params
        s, self.ctx, self.bkey = common.keys(self.T, self.config, p, self.gen)
        bits = torch.randint(0, 2, (self.traffic["pool"],), generator=self.gen,
                             device=self.device)
        self.pool = common.encrypt(s, bits, p, self.config["input_noise"], self.gen)
        self.secret, self.bits = s.cpu().numpy(), bits.cpu().numpy()

    def request(self, i: int) -> np.ndarray:
        """Pool indices of the batch's first inputs, then its second."""
        return self.rng.integers(0, self.bits.size, 2 * self.batch)

    def warm_requests(self) -> list:
        return [np.arange(2 * self.batch) % self.bits.size]

    def serve(self, req: np.ndarray) -> list:
        from sgfhe_tpu_torch.models import bootstrap as bs
        from sgfhe_tpu_torch.models.scheme1 import LWE

        idx = torch.from_numpy(req)
        a, b = (x[idx].to(self.device) for x in self.pool)
        B = self.batch
        out = bs.bootstrap_batch(self.params, self.ctx, self.bkey.hat, self.bkey.hat_shoup,
                                 LWE(a[:B], b[:B]), LWE(a[B:], b[B:]), self.words,
                                 prune=self.prune)
        return common.to_host(out)

    def expected(self, req: np.ndarray) -> list:
        return plain.gates(self.bits[req[:self.batch]], self.bits[req[self.batch:]])
