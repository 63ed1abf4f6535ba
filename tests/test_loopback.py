"""End-to-end loopback: TX -> channel -> RX, byte-exact recovery.

Mirrors the reference's qa_ofdm_adaptive_txrx.py:
 - test_direct: TX samples straight into the RX frame demod (no sync).
 - test_channel: padded stream through AWGN + CFO channel, Schmidl-Cox
   detection, byte-exact at high SNR (ref test_001_direct_txrx:49-114).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.ops import channel, constellation as cn
from gr_dtl_jax.models import receiver, transmitter


def _make_payloads(cfg, B, cnst_ids, rng):
    maxb = cfg.max_frame_bytes()
    payload = np.zeros((B, maxb), dtype=np.uint8)
    plen = np.zeros((B,), dtype=np.int32)
    for i in range(B):
        cap = cfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst_ids[i]])) - 4
        plen[i] = cap
        payload[i, :cap] = rng.randint(0, 256, size=cap)
    return payload, plen


@pytest.mark.parametrize("ctype", [1, 2, 3, 4])
def test_direct_txrx_per_constellation(ctype):
    cfg = cfgmod.make_tx_config(None, frame_length=10)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10)
    txp = transmitter.build_tx(cfg)
    rxp = receiver.build_rx(rxcfg)
    rng = np.random.RandomState(ctype)
    B = 4
    cnst = np.full((B,), ctype, np.int32)
    payload, plen = _make_payloads(cfg, B, cnst, rng)

    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(0),
    )
    rx = receiver.rx_frames(rxp, out.samples)
    assert bool(jnp.all(rx.header_ok)), "header CRC failed"
    np.testing.assert_array_equal(np.asarray(rx.cnst_id), cnst)
    assert bool(jnp.all(rx.crc_ok)), "payload CRC failed"
    np.testing.assert_array_equal(np.asarray(rx.payload_len), plen)
    np.testing.assert_array_equal(np.asarray(rx.payload), payload)
    np.testing.assert_array_equal(np.asarray(rx.frame_no), np.arange(B))


def test_channel_loopback_qpsk():
    """32 frames of QPSK through AWGN + fractional CFO, byte exact."""
    cfg = cfgmod.make_tx_config(None, frame_length=10)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10)
    txp = transmitter.build_tx(cfg)
    rxp = receiver.build_rx(rxcfg)
    rng = np.random.RandomState(42)
    B = 32
    cnst = np.full((B,), int(cn.ConstellationType.QPSK), np.int32)
    payload, plen = _make_payloads(cfg, B, cnst, rng)

    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(1),
    )
    stream = out.samples.reshape(-1)
    pad = 531  # unknown stream offset for the detector
    stream = jnp.concatenate(
        [jnp.zeros(pad, jnp.complex64), stream, jnp.zeros(400, jnp.complex64)]
    )
    # signal power ~ 52/64; 30 dB SNR
    sig_pow = float(jnp.mean(jnp.abs(out.samples) ** 2))
    noise_v = np.sqrt(sig_pow / 10 ** (30 / 10))
    stream = channel.channel_model(
        jax.random.PRNGKey(2), stream,
        noise_voltage=noise_v, freq_offset=0.31, fft_len=cfg.fft_len,
    )

    frames, eps = receiver.detect_and_extract(stream, rxcfg, B)
    # detector should report the injected fractional CFO
    np.testing.assert_allclose(np.asarray(eps), 0.31, atol=0.05)
    rx = receiver.rx_frames(rxp, frames)
    assert bool(jnp.all(rx.header_ok)), "header CRC failed"
    assert bool(jnp.all(rx.crc_ok)), "payload CRC failed"
    np.testing.assert_array_equal(np.asarray(rx.payload), payload)
    np.testing.assert_array_equal(np.asarray(rx.frame_no), np.arange(B))


def test_channel_loopback_integer_cfo():
    """Integer + fractional carrier offset exercises the coarse search."""
    cfg = cfgmod.make_tx_config(None, frame_length=10)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10)
    txp = transmitter.build_tx(cfg)
    rxp = receiver.build_rx(rxcfg)
    rng = np.random.RandomState(3)
    B = 8
    cnst = np.full((B,), int(cn.ConstellationType.QPSK), np.int32)
    payload, plen = _make_payloads(cfg, B, cnst, rng)

    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(4),
    )
    stream = jnp.concatenate(
        [jnp.zeros(100, jnp.complex64), out.samples.reshape(-1),
         jnp.zeros(200, jnp.complex64)]
    )
    sig_pow = float(jnp.mean(jnp.abs(out.samples) ** 2))
    noise_v = np.sqrt(sig_pow / 10 ** (30 / 10))
    # CFO = 2 carriers + 0.2 fractional
    stream = channel.channel_model(
        jax.random.PRNGKey(5), stream,
        noise_voltage=noise_v, freq_offset=2.2, fft_len=cfg.fft_len,
    )
    frames, eps = receiver.detect_and_extract(stream, rxcfg, B)
    rx = receiver.rx_frames(rxp, frames)
    np.testing.assert_array_equal(np.asarray(rx.carr_offset), 2)
    assert bool(jnp.all(rx.crc_ok)), "payload CRC failed under integer CFO"
    np.testing.assert_array_equal(np.asarray(rx.payload), payload)


@pytest.mark.slow
def test_channel_loopback_clock_drift():
    """Sample-clock offset (~60 ppm): per-frame trigger refinement must
    absorb the accumulating timing drift across 24 frames (the recorded
    -IQ replay scenario, BASELINE config 4)."""
    cfg = cfgmod.make_tx_config(None, frame_length=10)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10)
    txp = transmitter.build_tx(cfg)
    rxp = receiver.build_rx(rxcfg)
    rng = np.random.RandomState(5)
    B = 24
    cnst = np.full((B,), int(cn.ConstellationType.QPSK), np.int32)
    payload, plen = _make_payloads(cfg, B, cnst, rng)
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(6),
    )
    stream = np.concatenate(
        [np.zeros(400, np.complex64), np.asarray(out.samples).reshape(-1),
         np.zeros(300, np.complex64)]
    )
    # resample at (1 + 60ppm): linear interpolation on a stretched grid
    ppm = 60e-6
    t = np.arange(len(stream) - 2) * (1.0 + ppm)
    i0 = np.floor(t).astype(int)
    fr = t - i0
    drifted = (stream[i0] * (1 - fr) + stream[i0 + 1] * fr).astype(np.complex64)
    sig = float(np.mean(np.abs(np.asarray(out.samples)) ** 2))
    noisy = channel.awgn(jax.random.PRNGKey(7), jnp.asarray(drifted),
                         float(np.sqrt(sig / 10 ** 3)))
    frames, _ = receiver.detect_and_extract(noisy, rxcfg, B)
    rx = receiver.rx_frames(rxp, frames)
    ok = np.asarray(rx.crc_ok)
    # total drift over the capture is ~1.6 samples; all frames decode
    assert ok.all(), ok
    np.testing.assert_array_equal(np.asarray(rx.payload), payload)
