"""Constellation map/demap round trips per type + mixed batches + LLR signs.

Mirrors the reference QA pattern qa_ofdm_adaptive_chunks_to_symbols_bc.py:39-63
(map -> decision round trip per constellation).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.ops import constellation as cn


@pytest.mark.parametrize("ctype", [cn.ConstellationType.BPSK, cn.ConstellationType.QPSK,
                                   cn.ConstellationType.PSK8, cn.ConstellationType.QAM16])
def test_map_decision_roundtrip(ctype):
    bps = int(cn.BITS_PER_SYMBOL[ctype])
    syms = np.arange(1 << bps, dtype=np.int32)[None, :]
    cid = np.array([int(ctype)], dtype=np.int32)
    pts = cn.map_symbols(jnp.asarray(syms), jnp.asarray(cid))
    dec = cn.hard_decision(pts, jnp.asarray(cid))
    np.testing.assert_array_equal(np.asarray(dec), syms)


def test_qpsk_normalized_scaling():
    # ref constellation.cc:18-24 scales QPSK by 0.5
    pts = np.asarray(cn.POINTS[int(cn.ConstellationType.QPSK), :4])
    np.testing.assert_allclose(np.abs(pts), 0.5, atol=1e-6)


def test_mixed_batch_roundtrip():
    rng = np.random.RandomState(0)
    B, n = 8, 64
    cids = rng.randint(1, 5, size=B).astype(np.int32)
    syms = np.array([rng.randint(0, 1 << cn.BITS_PER_SYMBOL[c], size=n) for c in cids],
                    dtype=np.int32)
    pts = cn.map_symbols(jnp.asarray(syms), jnp.asarray(cids))
    noisy = np.asarray(pts) + 0.01 * (rng.randn(B, n) + 1j * rng.randn(B, n))
    dec = cn.hard_decision(jnp.asarray(noisy.astype(np.complex64)), jnp.asarray(cids))
    np.testing.assert_array_equal(np.asarray(dec), syms)


def test_llr_sign_convention():
    # noiseless symbols: LLR > 0 iff the transmitted bit is 0
    for ctype in (cn.ConstellationType.QPSK, cn.ConstellationType.QAM16):
        bps = int(cn.BITS_PER_SYMBOL[ctype])
        syms = np.arange(1 << bps, dtype=np.int32)[None, :]
        cid = np.array([int(ctype)], dtype=np.int32)
        pts = cn.map_symbols(jnp.asarray(syms), jnp.asarray(cid))
        llr = np.asarray(cn.soft_llrs(pts, jnp.asarray(cid), jnp.asarray([0.1])))
        for s in range(1 << bps):
            for b in range(bps):
                bit = (s >> b) & 1
                assert (llr[0, s, b] < 0) == (bit == 1), (ctype, s, b)
        # bits above bps are zeroed
        assert np.all(llr[..., bps:] == 0)


def test_min_distance_table():
    d = cn.min_distances()
    assert abs(d[int(cn.ConstellationType.BPSK)] - 2.0) < 1e-6
    assert abs(d[int(cn.ConstellationType.QAM16)] - 2.0 / np.sqrt(10)) < 1e-6


def test_soft_llrs_closed_form_matches_table_oracle():
    """The closed-form max-log slicers (soft_llrs) must agree with the
    generic table reduction (soft_llrs_table) for every constellation,
    mixed batches included — same subset-min distances, rearranged
    algebraically."""
    import numpy as np
    import jax.numpy as jnp
    from gr_dtl_jax.ops import constellation as cn

    rng = np.random.RandomState(42)
    B, n = 16, 64
    cid = np.repeat([1, 2, 3, 4], 4).astype(np.int32)
    y = (rng.randn(B, n) + 1j * rng.randn(B, n)).astype(np.complex64)
    # include points near decision boundaries and far outside the grid
    y[0, :8] = np.linspace(-3, 3, 8)
    y[4, :8] = 1j * np.linspace(-3, 3, 8)
    nv = np.full((B,), 0.31, np.float32)
    got = np.asarray(cn.soft_llrs(jnp.asarray(y), jnp.asarray(cid),
                                  jnp.asarray(nv)))
    want = np.asarray(cn.soft_llrs_table(jnp.asarray(y), jnp.asarray(cid),
                                         jnp.asarray(nv)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_soft_llrs_signs_recover_hard_decision():
    """LLR signs must agree with the nearest-point slicer bits (max-log
    LLR < 0 <=> nearest point has that bit = 1)."""
    import numpy as np
    import jax.numpy as jnp
    from gr_dtl_jax.ops import constellation as cn

    rng = np.random.RandomState(7)
    for cid in (1, 2, 3, 4):
        bps = int(cn.BITS_PER_SYMBOL[cid])
        y = (rng.randn(256) + 1j * rng.randn(256)).astype(np.complex64)
        llr = np.asarray(cn.soft_llrs(jnp.asarray(y[None]),
                                      jnp.asarray([cid]),
                                      jnp.asarray([0.1])))[0]
        sym, _ = cn.nearest_point(jnp.asarray(y[None]), jnp.asarray([cid]))
        sym = np.asarray(sym)[0]
        for k in range(bps):
            want = (sym >> k) & 1
            got = (llr[:, k] < 0).astype(np.int64)
            # ignore exact-boundary symbols (measure zero, llr == 0)
            m = np.abs(llr[:, k]) > 1e-6
            assert (got[m] == want[m]).all(), (cid, k)
