"""sgfhe_tpu_torch — the PyTorch and CUDA port of sgfhe_tpu for one NVIDIA
H100: Gao's gate-bootstrapping scheme 1 (eprint 2018/637) with RNS limbs,
a balanced mixed-radix gadget and an exact Q->r switch.

It imports torch and numpy, never JAX and nothing of sgfhe_tpu. Entry
points run on "cuda" unless the caller passes device="cpu". The blind
rotation runs through hand-written CUDA kernels (csrc/rotate.cu) on the
card and through their plain PyTorch versions on the CPU.

This slice ports the scheme-1 gate bootstrap: keys, private-key
encryption, split, bootstrap, decryption. See ROADMAP.md for what is still
to port.
"""

from .models.params import Params
from .models.scheme1 import (
    SchemeContext,
    make_context,
    RLWE,
    LWE,
    PackedCiphertext,
    EncryptedBit,
    PrivateKey,
    BootstrapKey,
    encrypt,
    decrypt,
    decrypt_bit,
    split_ciphertext,
    deterministic_expand,
)
from .models.bootstrap import bootstrap, bootstrap_batch

__all__ = [
    "Params", "SchemeContext", "make_context",
    "RLWE", "LWE", "PackedCiphertext", "EncryptedBit",
    "PrivateKey", "BootstrapKey",
    "encrypt", "decrypt", "decrypt_bit", "split_ciphertext",
    "deterministic_expand",
    "bootstrap", "bootstrap_batch",
]
