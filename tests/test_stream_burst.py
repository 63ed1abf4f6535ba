"""Streaming feedback reverse channel: continuous
burst scanning (0..n bursts per block, boundary-straddling, noise-only
blocks) and a lossy/jittery streaming simplex session whose adaptation
still converges.

Reference behavior being matched: the feedback parser scans an endless
stream with a sliding access-code correlator
(ofdm_adaptive_feedback_format.cc:119-146) behind corr_est_cc
(ofdm_adaptive_tx.py:44-60); TX keeps its MCS until a burst decodes.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.ops import burst, channel, constellation as cn
from gr_dtl_jax.models import session
from gr_dtl_jax.utils import config as cfgmod


def _place(block, wave, pos):
    block[pos: pos + len(wave)] += wave


def test_stream_burst_rx_multi_and_straddle():
    """3 bursts over 2 blocks — two inside block 1, one straddling the
    block boundary — plus a noise-only block: every burst decoded
    exactly once, nothing fabricated from noise."""
    modem = burst.build_burst_modem()
    L = burst.burst_wave_len(modem)
    N = 4096
    rng = np.random.RandomState(0)

    def wave(c, f):
        return np.asarray(burst.burst_tx(
            jnp.asarray([c], jnp.int32), jnp.asarray([f], jnp.int32),
            modem, pad=0))[0]

    blocks = np.zeros((3, N), np.complex64)
    _place(blocks[0], wave(2, 1), 100)
    _place(blocks[0], wave(3, 0), 2000)
    straddle = wave(4, 2)
    cut = 60  # burst starts 60 samples before the boundary
    blocks[0][N - cut:] += straddle[:cut]
    blocks[1][: L - cut] += straddle[cut:]
    # block 2 left as pure noise
    noisy = blocks + (rng.randn(3, N) + 1j * rng.randn(3, N)).astype(
        np.complex64) * 0.05
    # small CFO over the whole capture
    n = np.arange(3 * N).reshape(3, N)
    noisy = (noisy * np.exp(1j * 0.001 * n)).astype(np.complex64)

    rx = session.StreamBurstRx(N, modem)
    got = []
    for b in range(3):
        out = rx.process(noisy[b])
        ok = np.asarray(out.ok)
        for i in np.nonzero(ok)[0]:
            got.append((int(np.asarray(out.cnst_id)[i]),
                        int(np.asarray(out.fec_id)[i])))
    assert sorted(got) == [(2, 1), (3, 0), (4, 2)], got


def test_stream_burst_rx_rejects_noise():
    """A long noise-only stream must produce zero decoded bursts."""
    modem = burst.build_burst_modem()
    N = 4096
    rng = np.random.RandomState(3)
    rx = session.StreamBurstRx(N, modem)
    for _ in range(4):
        blk = (rng.randn(N) + 1j * rng.randn(N)).astype(np.complex64) * 0.3
        out = rx.process(blk)
        assert not np.asarray(out.ok).any()


def test_stream_simplex_lossy_adaptation():
    """Forward link at 30 dB, reverse bursts at random offsets with 50%
    of reverse blocks blacked out + AWGN + CFO: TX still climbs to
    QAM16, and never moves on blocks where the burst was lost."""
    txcfg = cfgmod.make_tx_config(None, frame_length=10,
                                  max_empty_frames=-1)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10)
    rng = np.random.RandomState(7)
    drop_log = []

    def chan_fwd(s):
        sig = float(np.mean(np.abs(s) ** 2)) or 1.0
        nv = np.sqrt(sig / 10 ** 3.0)  # 30 dB
        return s + (rng.randn(*s.shape) + 1j * rng.randn(*s.shape)) * nv / np.sqrt(2)

    def chan_rev(s):
        drop = rng.rand() < 0.5
        drop_log.append(drop)
        out = np.zeros_like(s) if drop else np.asarray(s).copy()
        n = np.arange(len(out))
        out = out * np.exp(1j * 0.0015 * n)  # CFO
        return out + (rng.randn(*out.shape) + 1j * rng.randn(*out.shape)).astype(
            np.complex64) * 0.02

    spx = session.StreamSimplex(txcfg, rxcfg, chan_fwd, chan_rev,
                                frames_per_block=8, seed=5)
    spx.tx.send(b"\x55" * 64)  # something in the queue; then empty frames
    cnst_before = spx.tx.constellation
    history = []
    for _ in range(16):
        r = spx.step()
        assert r is not None
        history.append((r["want"], r["applied"], spx.tx.constellation))
    assert cnst_before == int(cn.ConstellationType.BPSK)
    assert spx.tx.constellation == int(cn.ConstellationType.QAM16), history
    # at least one reverse block was dropped and at least one burst
    # got through (otherwise the test isn't exercising loss)
    assert any(drop_log) and not all(drop_log)
    applied = [h[1] for h in history]
    assert any(a is None for a in applied)  # lost-burst steps happened
    assert any(a is not None for a in applied)
