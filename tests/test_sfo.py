"""Sample-clock-offset (SFO) robustness: ±50 ppm
TX/RX clock mismatch over a long capture must be absorbed by the
per-block trigger phase vote + lock tracking (the reference dedicates
ofdm_adaptive_frame_detect_bb to exactly this drift,
frame_detect_bb_impl.cc:64-173)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.ops import channel, constellation as cn
from gr_dtl_jax.models import session, transmitter


def test_sfo_interpolator_fidelity():
    """The cubic resampler at 0 ppm is the identity; at 50 ppm it shifts
    a pure tone without meaningful distortion (> 35 dB SNR)."""
    n = np.arange(20000)
    tone = np.exp(1j * 2 * np.pi * 0.11 * n).astype(np.complex64)
    out0 = np.asarray(channel.sample_clock_offset(jnp.asarray(tone), 0.0))
    np.testing.assert_allclose(out0, tone, atol=1e-5)
    out = np.asarray(channel.sample_clock_offset(jnp.asarray(tone), 50.0))
    # expected: the same tone sampled at n*(1+5e-5)
    want = np.exp(1j * 2 * np.pi * 0.11 * n * (1 + 50e-6)).astype(np.complex64)
    err = out[100:-100] - want[100:-100]
    snr = 10 * np.log10(np.mean(np.abs(want) ** 2) / np.mean(np.abs(err) ** 2))
    assert snr > 35.0, snr


@pytest.mark.parametrize("ppm", [50.0, -50.0])
@pytest.mark.slow
def test_stream_rx_sfo_drift(ppm):
    """200 frames (~10 samples of cumulative drift) at ±50 ppm + 25 dB
    AWGN: every frame decodes exactly once through StreamRx."""
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    F = 8
    n_blocks = 25
    B = F * n_blocks  # 200 frames -> 208k samples -> 10.4 samples drift
    rng = np.random.RandomState(int(abs(ppm)))
    maxb = txcfg.max_frame_bytes()
    plen = np.full(B, txcfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen),
        jnp.full(B, 2, jnp.int32), jnp.zeros(B, jnp.int32),
        jnp.arange(B, dtype=jnp.int32), jax.random.PRNGKey(0))
    samples = np.asarray(out.samples).reshape(-1)

    rx = session.StreamRx(cfg, frames_per_block=F)
    S = rx.block_samples
    stream = np.concatenate([samples, np.zeros(2 * S, np.complex64)])
    stream = np.asarray(channel.sample_clock_offset(jnp.asarray(stream), ppm))
    sig = float(np.mean(np.abs(samples) ** 2))
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(1), jnp.asarray(stream),
        float(np.sqrt(sig / 10 ** 2.5))))  # 25 dB
    stream = stream[: (len(stream) // S) * S]

    decoded = {}
    for b in range(len(stream) // S):
        outb, valid = rx.process(stream[b * S:(b + 1) * S])
        ok = np.asarray(outb.crc_ok) & valid
        nos = np.asarray(outb.frame_no)
        for i in range(F):
            if ok[i]:
                fno = int(nos[i])
                assert fno not in decoded, f"frame {fno} decoded twice"
                pay = np.asarray(outb.payload)[i, : plen[fno]]
                assert pay.tobytes() == payload[fno, : plen[fno]].tobytes()
                decoded[fno] = True
    # the drift must not cost frames: all 200 decode, exactly once
    assert len(decoded) >= B - 1, (len(decoded), B)
    assert rx.n_lost <= 1
