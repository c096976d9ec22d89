"""Opt-in progress logging for the long set-up paths (counterpart of
sgfhe_tpu/utils/progress.py, the same switch and line format).

The first run at n = 512 and up spends seconds building the CUDA kernels
and the bootstrap key with no output; `SGFHE_PROGRESS=1` (or
`enable(True)`) makes those stages narrate to stderr with timestamps.
`sgfhe_tpu_torch.prewarm` turns this on for its own run by default.
"""

from __future__ import annotations

import os
import sys
import time

_FORCED: bool | None = None
_T0 = time.time()


def enable(on: bool = True) -> None:
    global _FORCED
    _FORCED = on


def enabled() -> bool:
    if _FORCED is not None:
        return _FORCED
    return os.environ.get("SGFHE_PROGRESS", "") not in ("", "0")


def log(msg: str) -> None:
    if enabled():
        print(f"[sgfhe +{time.time() - _T0:7.1f}s] {msg}",
              file=sys.stderr, flush=True)


class stage:
    """Context manager: `with stage("build kernels"): ...` logs entry and
    the elapsed time on exit (only when progress is enabled)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.time()
        log(f"{self.name} ...")
        return self

    def __exit__(self, *exc):
        log(f"{self.name} done in {time.time() - self.t:.1f}s")
        return False
