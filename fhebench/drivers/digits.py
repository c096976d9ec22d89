"""k-bit digit additions with carry (scheme 2): each request is one
`add_with_carry` call on `batch` digit pairs and carry-in bits drawn by the
seed from pools of encrypted digits and bits; its answers are the sum
digits and the carries-out, on the host."""

from __future__ import annotations

import numpy as np
import torch

from fhebench.drivers import common
from fhebench.reference import plain


class Driver(common.Driver):
    def __init__(self, *args):
        super().__init__(*args)
        self.batch = self.traffic["batch"]
        self.work = {"adds": self.batch}

    def setup(self) -> None:
        p, size, bound = self.params, self.traffic["pool"], self.config["input_noise"]
        s, self.ctx, self.bkey = common.keys(self.T, self.config, p, self.gen)
        digits = torch.randint(0, 2**p.k, (size,), generator=self.gen, device=self.device)
        carries = torch.randint(0, 2, (size,), generator=self.gen, device=self.device)
        self.pools = [common.encrypt(s, digits, p, bound, self.gen),
                      common.encrypt(s, carries, p, bound, self.gen)]
        self.secret = s.cpu().numpy()
        self.digits, self.carries = digits.cpu().numpy(), carries.cpu().numpy()

    def request(self, i: int) -> np.ndarray:
        """(3, batch) pool indices: x and y into the digits, c into the carries."""
        return self.rng.integers(0, self.digits.size, (3, self.batch))

    def warm_requests(self) -> list:
        return [np.arange(3 * self.batch).reshape(3, self.batch) % self.digits.size]

    def serve(self, req: np.ndarray) -> list:
        from sgfhe_tpu_torch.models import bootstrap2 as b2
        from sgfhe_tpu_torch.models.scheme1 import LWE

        pools = (self.pools[0], self.pools[0], self.pools[1])
        x, y, c = (LWE(*(t[torch.from_numpy(i)].to(self.device) for t in pool))
                   for pool, i in zip(pools, req))
        out = b2.add_with_carry(self.params, self.ctx, self.bkey, x, y, c, self.words,
                                prune=self.prune)
        return common.to_host(out)

    def expected(self, req: np.ndarray) -> list:
        return plain.add_with_carry(self.digits[req[0]], self.digits[req[1]],
                                    self.carries[req[2]], self.params.k)
