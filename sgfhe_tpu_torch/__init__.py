"""sgfhe_tpu_torch — the PyTorch and CUDA port of sgfhe_tpu for one NVIDIA
H100: Gao's gate-bootstrapping scheme 1 (eprint 2018/637) with RNS limbs,
a balanced mixed-radix gadget and an exact Q->r switch, and the k-bit
scheme 2 (eprint 2019/521) with its functional bootstrap.

It imports torch and numpy, never JAX and nothing of sgfhe_tpu. Entry
points run on "cuda" unless the caller passes device="cpu". The blind
rotation of both schemes runs through hand-written CUDA kernels
(csrc/rotate.cu) on the card and through their plain PyTorch versions on
the CPU.

Ported so far: scheme 1's keys (private, public, bootstrap), private,
public and space-optimal encryption, split, gate bootstrap, packing and
decryption; scheme 2 (`Scheme2`: params, keys, encryption; `Scheme2Boot`:
add_with_carry, apply_lut, refresh, mul; `models.wideint`: wide-integer
arithmetic over its digits), the boolean-circuit layer (`circuit`:
`Circuit`, `evaluate_circuit`), the noise debugger (`debug.noise`), and
the wire frames and npz checkpoints of keys and ciphertexts (`serialize`,
byte for byte the JAX package's, over the C++ codec of `native`), and the
tooling: `prewarm` (cold-start priming), `utils.progress` (stage
narration, SGFHE_PROGRESS), `utils.profiling` (`timeit`, `trace`, and
the program's spans: `span`, `spans`, `on_trace_clock`), the golden
model `refimpl.golden`, and the single-card examples (`examples`:
adder, depth, errors, scheme2_demo, scheme2_add, scaling,
scheme2_dist), and the multi-device layer (`parallel`: meshes,
the process group, sharded gate batches and packs, and the
tensor-parallel rotation, on torch.distributed). Scheme 2 runs on the
card at every k of the paper, 1 to 5, at n = 1024.
"""

from .models.params import Params
from .models.scheme1 import (
    SchemeContext,
    make_context,
    RLWE,
    LWE,
    PackedCiphertext,
    Ciphertext,
    EncryptedBit,
    PrivateEncryptedCiphertext,
    PublicEncryptedCiphertext,
    PrivateKey,
    PublicKey,
    BootstrapKey,
    encrypt,
    encrypt_public,
    encrypt_optimal,
    normalize_ciphertext,
    decrypt,
    decrypt_bit,
    split_ciphertext,
    deterministic_expand,
)
from .models.bootstrap import bootstrap, bootstrap_batch, pack_encrypted_bits
from .models import scheme2 as Scheme2  # noqa: F401
from .models import bootstrap2 as Scheme2Boot  # noqa: F401
from . import circuit  # noqa: F401  (boolean-circuit evaluation layer)
from .circuit import Circuit, evaluate as evaluate_circuit
from . import serialize  # noqa: F401  (wire frames, checkpoints)
from .prewarm import prewarm

__all__ = [
    "Params", "SchemeContext", "make_context",
    "RLWE", "LWE", "PackedCiphertext", "Ciphertext", "EncryptedBit",
    "PrivateEncryptedCiphertext", "PublicEncryptedCiphertext",
    "PrivateKey", "PublicKey", "BootstrapKey",
    "encrypt", "encrypt_public", "encrypt_optimal", "normalize_ciphertext",
    "decrypt", "decrypt_bit", "split_ciphertext", "deterministic_expand",
    "bootstrap", "bootstrap_batch", "pack_encrypted_bits",
    "Scheme2", "Scheme2Boot",
    "circuit", "Circuit", "evaluate_circuit", "serialize", "prewarm",
]
