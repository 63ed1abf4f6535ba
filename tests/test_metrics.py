"""Diagnostics: constellation metric + lost-frame counter."""

import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.ops import constellation as cn, metrics


def test_constellation_metric_zero_for_exact():
    rng = np.random.RandomState(0)
    B, S, C = 2, 4, 48
    cid = np.array([2, 4], np.int32)
    syms = np.stack([rng.randint(0, 1 << int(cn.BITS_PER_SYMBOL[c]), (S, C))
                     for c in cid])
    pts = cn.map_symbols(jnp.asarray(syms), jnp.asarray(cid)[:, None, None])
    m = metrics.constellation_metric(pts, pts, jnp.asarray(cid))
    assert m.shape == (B, C)
    np.testing.assert_allclose(np.asarray(m), 0.0, atol=1e-12)
    # a known offset produces |err|^2 / min_dist
    off = pts + 0.1
    m2 = np.asarray(metrics.constellation_metric(pts, off, jnp.asarray(cid)))
    want = 0.01 / np.asarray(cn.MIN_DIST)[cid]
    np.testing.assert_allclose(m2, np.broadcast_to(want[:, None], m2.shape), rtol=1e-4)


def test_lost_frames_gap_and_wrap():
    # 0,1,2, [3,4 lost], 5, then wrap 4094,4095,0,1
    nos = np.array([0, 1, 2, 5, 4094, 4095, 0, 1], np.int32)
    ok = np.ones(8, bool)
    n_lost, n_total, rate = metrics.lost_frames(jnp.asarray(nos), jnp.asarray(ok))
    # gap 3,4 lost (2) + gap 6..4093 (4088) from the jump to 4094
    assert int(n_lost) == 2 + 4088
    assert int(n_total) == int(n_lost) + 8


def test_lost_frames_bad_header_counts():
    nos = np.array([0, 1, 2, 3], np.int32)
    ok = np.array([True, False, True, True])
    n_lost, n_total, rate = metrics.lost_frames(jnp.asarray(nos), jnp.asarray(ok))
    assert int(n_lost) == 1 and int(n_total) == 4
    assert abs(float(rate) - 0.25) < 1e-6
