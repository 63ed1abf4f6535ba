"""Bit repack round trips, incl. per-frame variable bps (adaptive batches).

Mirrors qa_ofdm_adaptive_frame_pack_bb.py:38-66 (repack exactness) but for
the batched stateless design.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.ops import repack


def test_bytes_bits_roundtrip():
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, size=(4, 32)).astype(np.uint8)
    bits = repack.bytes_to_bits(jnp.asarray(data))
    back = repack.bits_to_bytes(bits)
    np.testing.assert_array_equal(np.asarray(back), data)
    # LSB-first convention
    one = np.array([[1]], dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(repack.bytes_to_bits(jnp.asarray(one)))[0],
                                  [1, 0, 0, 0, 0, 0, 0, 0])


@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_fixed_bps_roundtrip(bps):
    rng = np.random.RandomState(bps)
    n_bytes = 24  # divisible by all bps after *8
    data = rng.randint(0, 256, size=(2, n_bytes)).astype(np.uint8)
    n_sym = n_bytes * 8 // bps
    b = np.full((2,), bps, dtype=np.int32)
    syms = repack.bytes_to_symbols(jnp.asarray(data), jnp.asarray(b), n_sym)
    assert int(jnp.max(syms)) < (1 << bps)
    back = repack.symbols_to_bytes(syms, jnp.asarray(b), n_bytes)
    np.testing.assert_array_equal(np.asarray(back), data)


def test_mixed_bps_batch():
    rng = np.random.RandomState(7)
    n_sym = 960  # 20 symbols * 48 carriers
    bps = np.array([1, 2, 3, 4], dtype=np.int32)
    max_bytes = n_sym * 4 // 8
    data = np.zeros((4, max_bytes), dtype=np.uint8)
    for i, k in enumerate(bps):
        nb = n_sym * int(k) // 8
        data[i, :nb] = rng.randint(0, 256, size=nb)
    syms = repack.bytes_to_symbols(jnp.asarray(data), jnp.asarray(bps), n_sym)
    back = repack.symbols_to_bytes(syms, jnp.asarray(bps), max_bytes)
    np.testing.assert_array_equal(np.asarray(back), data)
