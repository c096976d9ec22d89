"""The port's host IO codec (sgfhe_tpu_torch/native.py over
csrc/sgfhe_io.cpp) against its plain numpy versions, the JAX package's
codec (sgfhe_tpu/native.py) and zlib, at every width from 1 to 32."""

import zlib

import numpy as np
import pytest

from sgfhe_tpu import native as ref
from sgfhe_tpu_torch import native


def test_library_builds_into_build_dir():
    lib = native.load()
    assert native._target().is_file() and native._target().parent == native.BUILD_DIR
    assert lib is native.load()


@pytest.mark.parametrize("n_bits", [0, 1, 7, 8, 9, 64, 1000, 6 * 1024 + 3])
def test_packbits(n_bits):
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, n_bits).astype(np.uint8)
    packed = native.packbits(bits)
    assert packed.tobytes() == native.plain_packbits(bits).tobytes() == ref.packbits(bits)
    np.testing.assert_array_equal(native.unpackbits(packed, n_bits), bits)
    np.testing.assert_array_equal(native.plain_unpackbits(packed, n_bits), bits)
    np.testing.assert_array_equal(native.unpackbits(packed.tobytes(), n_bits),
                                  ref.unpackbits(packed.tobytes(), n_bits))


@pytest.mark.parametrize("width", range(1, 33))
def test_pack_uint(width):
    rng = np.random.default_rng(width)
    for count in (1, 3, 8, 257):
        vals = rng.integers(0, 1 << width, count, dtype=np.uint64).astype(np.uint32)
        packed = native.pack_uint(vals, width)
        assert packed.size == (count * width + 7) // 8
        assert packed.tobytes() == native.plain_pack_uint(vals, width).tobytes()
        assert packed.tobytes() == ref.pack_uint(vals, width)
        for unpack in (native.unpack_uint, native.plain_unpack_uint):
            np.testing.assert_array_equal(unpack(packed, count, width), vals)
        np.testing.assert_array_equal(ref.unpack_uint(packed.tobytes(), count, width), vals)
    # bits above the width are dropped, as in the JAX package's codec
    wide = np.full(5, 0xFFFFFFFF, dtype=np.uint32)
    assert native.pack_uint(wide, width).tobytes() == ref.pack_uint(wide, width)


def test_unpack_refuses_short_data_and_bad_widths():
    packed = native.pack_uint(np.arange(10, dtype=np.uint32), 7)
    with pytest.raises(ValueError, match="truncated"):
        native.unpack_uint(packed[:-1], 10, 7)
    with pytest.raises(ValueError, match="truncated"):
        native.unpackbits(b"\x01", 9)
    for width in (0, 33):
        with pytest.raises(ValueError, match="width"):
            native.pack_uint(np.arange(3, dtype=np.uint32), width)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 13, 1024, 4099])
def test_crc32_matches_zlib_and_chains(n):
    data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8).tobytes()
    want = zlib.crc32(data) & 0xFFFFFFFF
    assert native.crc32(data) == native.plain_crc32(data) == ref.crc32(data) == want
    for cut in (0, n // 3, n):
        assert native.crc32(data[cut:], native.crc32(data[:cut])) == want
        assert native.crc32(memoryview(data)[cut:], native.plain_crc32(data[:cut])) == want
