"""Feedback burst modem: format/parse round trip + impaired-channel
recovery (mirrors qa_ofdm_adaptive_feedback_format.py:53-123 and the
reverse-channel part of qa_ofdm_adaptive_txrx.py test_002)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.ops import burst, channel


def test_burst_bits_layout():
    modem = burst.build_burst_modem()
    bits = np.asarray(burst._burst_bits(
        jnp.asarray([3], jnp.int32), jnp.asarray([1], jnp.int32), modem))
    assert bits.shape == (1, 88)
    np.testing.assert_array_equal(bits[0, :64], burst.ACCESS_CODE_BITS)
    # cnst byte MSB-first: 3 -> 00000011
    np.testing.assert_array_equal(bits[0, 64:72], [0, 0, 0, 0, 0, 0, 1, 1])
    np.testing.assert_array_equal(bits[0, 72:80], [0, 0, 0, 0, 0, 0, 0, 1])


def test_burst_clean_roundtrip():
    modem = burst.build_burst_modem()
    cnst = jnp.asarray([1, 2, 3, 4], jnp.int32)
    fec = jnp.asarray([0, 1, 2, 0], jnp.int32)
    wave = burst.burst_tx(cnst, fec, modem)
    out = burst.burst_rx(wave, modem)
    assert bool(jnp.all(out.ok)), np.asarray(out.ok)
    np.testing.assert_array_equal(np.asarray(out.cnst_id), np.asarray(cnst))
    np.testing.assert_array_equal(np.asarray(out.fec_id), np.asarray(fec))


def test_burst_impaired_channel():
    """Phase rotation + small CFO + amplitude + AWGN + unknown delay."""
    modem = burst.build_burst_modem()
    rng = np.random.RandomState(0)
    B = 16
    cnst = jnp.asarray(rng.randint(1, 5, B), jnp.int32)
    fec = jnp.asarray(rng.randint(0, 3, B), jnp.int32)
    wave = np.asarray(burst.burst_tx(cnst, fec, modem, pad=16))
    # random integer delay per burst + gain/phase/CFO
    N = wave.shape[1] + 40
    rx = np.zeros((B, N), np.complex64)
    for i in range(B):
        d = rng.randint(0, 40)
        gain = 0.5 + rng.rand()
        ph = rng.uniform(-np.pi, np.pi)
        cfo = rng.uniform(-0.01, 0.01)  # rad/sample
        n = np.arange(wave.shape[1])
        rx[i, d : d + wave.shape[1]] = (
            wave[i] * gain * np.exp(1j * (ph + cfo * n))
        )
    rx = np.asarray(channel.awgn(jax.random.PRNGKey(1), jnp.asarray(rx), 0.05))
    out = burst.burst_rx(jnp.asarray(rx), modem)
    assert bool(jnp.all(out.ok)), (np.asarray(out.ok), np.asarray(out.cfo))
    np.testing.assert_array_equal(np.asarray(out.cnst_id), np.asarray(cnst))
    np.testing.assert_array_equal(np.asarray(out.fec_id), np.asarray(fec))


def test_burst_crc_gates_noise():
    modem = burst.build_burst_modem()
    noise = channel.awgn(jax.random.PRNGKey(2),
                         jnp.zeros((8, 300), jnp.complex64), 1.0)
    out = burst.burst_rx(noise, modem)
    assert not bool(jnp.any(out.ok))
