"""Scrambler round trip + loopback through time-varying selective fading
(the reference example's channel with the fading option, SURVEY.md §2e)."""

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.ops import channel, constellation as cn, scramble
from gr_dtl_jax.models import receiver, transmitter
import pytest


def test_scrambler_involution_and_whitening():
    rng = np.random.RandomState(0)
    frames = jnp.asarray(rng.randint(0, 256, (4, 100)).astype(np.uint8))
    s = scramble.scramble_frames(frames)
    back = scramble.scramble_frames(s)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(frames))
    # all-zero input becomes the LFSR sequence itself (nontrivial)
    z = scramble.scramble_frames(jnp.zeros((1, 100), jnp.uint8))
    assert np.asarray(z).sum() > 0
    # seed 0 disables
    np.testing.assert_array_equal(
        np.asarray(scramble.scramble_frames(frames, seed=0)), np.asarray(frames))


@pytest.mark.slow
def test_scrambled_loopback():
    cfg = cfgmod.make_tx_config(None, frame_length=10, scramble_bits=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10, scramble_bits=True)
    txp, rxp = transmitter.build_tx(cfg), receiver.build_rx(rxcfg)
    rng = np.random.RandomState(1)
    B = 4
    cnst = np.full(B, 2, np.int32)
    plen = np.full(B, cfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((B, cfg.max_frame_bytes()), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(0))
    rx = receiver.rx_frames(rxp, out.samples)
    assert bool(jnp.all(rx.crc_ok))
    np.testing.assert_array_equal(np.asarray(rx.payload), payload)
    # a non-scrambling receiver must NOT validate scrambled frames
    rx_plain = receiver.rx_frames(
        receiver.build_rx(cfgmod.make_rx_config(None, frame_length=10)),
        out.samples)
    assert not bool(jnp.any(rx_plain.crc_ok))


@pytest.mark.slow
def test_fading_loopback():
    """QPSK frames through slow Rayleigh selective fading + AWGN: the
    pilot-tracking equalizer follows the channel; most frames decode."""
    cfg = cfgmod.make_tx_config(None, frame_length=10)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10)
    txp, rxp = transmitter.build_tx(cfg), receiver.build_rx(rxcfg)
    rng = np.random.RandomState(2)
    B = 16
    cnst = np.full(B, 2, np.int32)
    plen = np.full(B, cfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((B, cfg.max_frame_bytes()), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(1))
    stream = jnp.concatenate(
        [jnp.zeros(300, jnp.complex64), out.samples.reshape(-1),
         jnp.zeros(200, jnp.complex64)])
    faded = channel.selective_fading(
        jax.random.PRNGKey(3), stream,
        delays=(0, 2, 5), powers_db=(0.0, -6.0, -9.0), doppler_norm=2e-5)
    sig = float(jnp.mean(jnp.abs(out.samples) ** 2))
    noisy = channel.awgn(jax.random.PRNGKey(4), faded, float(np.sqrt(sig / 10**2.8)))
    frames, _ = receiver.detect_and_extract(noisy, rxcfg, B)
    rx = receiver.rx_frames(rxp, frames)
    ok = np.asarray(rx.crc_ok)
    assert ok.mean() >= 0.7, (ok, np.asarray(rx.snr_db))
    np.testing.assert_array_equal(np.asarray(rx.payload)[ok], payload[ok])


def test_lfsr_matches_gr_semantics():
    """Bit-exact with gr::digital::lfsr(0x8a, 0x7f, 7): the feedback bit
    shifts into bit position reg_len (8-bit state), giving a short
    transient from seed 0x7F and then a 63-bit cycle."""
    seq = np.unpackbits(scramble.lfsr_bytes(0x8A, 0x7F, 7, 256),
                        bitorder="little")
    # bits from the gr lfsr recurrence computed independently
    reg, want = 0x7F, []
    for _ in range(128):
        want.append(reg & 1)
        reg = (reg >> 1) | ((bin(reg & 0x8A).count("1") & 1) << 7)
    np.testing.assert_array_equal(seq[:128], want)
    # settles into a 63-bit cycle after the transient
    assert (seq[512 : 512 + 63] == seq[512 + 63 : 512 + 126]).all()
