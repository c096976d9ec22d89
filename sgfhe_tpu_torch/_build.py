"""Build and load the package's CUDA kernels.

Each source under csrc/ is compiled by `nvcc` for sm_90a into a shared
library with a plain C interface, at first use, into build/kernels/ at the
root of the checkout (git-ignored), and loaded with ctypes: rotate.cu (the
rotation's step pair) and rotate_resident.cu (the whole rotation in one
launch), both on the helpers of rotate_common.cuh. The library's file name
carries a hash of its source, the headers and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. Nothing
here runs at import time: a host without nvcc imports the package and uses
the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("rotate.cu", "rotate_resident.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(source: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    text = (CSRC / source).read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _start(source: str):
    """Start nvcc for one source unless its library exists; returns
    (target, process or None, temp path or None)."""
    target = _target(source)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, proc, tmp


def build_all() -> dict[str, Path]:
    """Compile every source not yet built, all nvcc processes at once;
    raise with the compiler's output if one fails."""
    started = [(s, *_start(s)) for s in SOURCES]
    errors = []
    for source, target, proc, tmp in started:
        if proc is None:
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {source}:\n{out}")
        else:
            os.replace(tmp, target)  # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return {s: t for s, t, _, _ in started}


def load(source: str = "rotate.cu") -> ctypes.CDLL:
    """The loaded library of one source, built first if needed (every
    source not yet built is built with it)."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[source]))
        for name, args in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        _loaded[source] = lib
    return lib


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_SIGNATURES = {
    "rotate.cu": {
        "sg_flatten_ntt_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _U, _P, _P],
        "sg_mac_rotate_ntt_inv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
        "sg_consts_words": [],
    },
    "rotate_resident.cu": {
        "sg_rotate_resident": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _U,
                               _P, _P],
    },
}
