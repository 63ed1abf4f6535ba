"""Full OFDM loopback with LDPC FEC (ref qa_ofdm_adaptive_txrx.py
test_003_direct_fec_txrx): TX (coded, long header) -> channel -> RX
(soft demap + BP) -> exact payload recovery; and FEC-vs-uncoded gain."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
from gr_dtl_jax.ops import channel, constellation as cn
from gr_dtl_jax.models import fec_chain, receiver, transmitter

ALIST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "n_0100_k_0027.alist")


def _setup(frame_length=10):
    cfg = cfgmod.make_tx_config(None, frame_length=frame_length, fec=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=frame_length, fec=True)
    H = alist_mod.load_alist(ALIST)
    fec = fec_chain.build_fec(cfg, H)
    txp = transmitter.build_tx(cfg, fec)
    rxp = receiver.build_rx(rxcfg, fec)
    return cfg, rxcfg, fec, txp, rxp


@pytest.mark.parametrize("ctype", [1, 2, 3, 4])
def test_fec_direct_txrx(ctype):
    cfg, rxcfg, fec, txp, rxp = _setup()
    rng = np.random.RandomState(ctype)
    B = 4
    cnst = np.full(B, ctype, np.int32)
    plen = np.full(B, int(fec["user_bytes_tab"][int(cn.BITS_PER_SYMBOL[ctype])]),
                   np.int32)
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])

    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(0),
    )
    # long header -> one extra OFDM symbol per frame
    assert out.samples.shape == (B, cfg.frame_samples)
    assert cfg.frame_ofdm_symbols == 2 + 2 + 10

    rx = receiver.rx_frames(rxp, out.samples)
    assert bool(jnp.all(rx.header_ok))
    assert bool(jnp.all(rx.fec_ok))
    assert bool(jnp.all(rx.crc_ok))
    np.testing.assert_array_equal(np.asarray(rx.payload_len), plen)
    np.testing.assert_array_equal(np.asarray(rx.payload), payload)


@pytest.mark.slow
def test_fec_beats_uncoded_at_low_snr():
    """At an SNR where uncoded BPSK frames always fail, coded frames pass."""
    cfg, rxcfg, fec, txp, rxp = _setup()
    rng = np.random.RandomState(9)
    B = 16
    cnst = np.full(B, 1, np.int32)
    plen = np.full(B, int(fec["user_bytes_tab"][1]), np.int32)
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(1),
    )
    sig = float(jnp.mean(jnp.abs(out.samples) ** 2))
    # ~6 dB: raw BPSK BER ~ 4e-3 -> a 480-bit uncoded payload fails
    # ~85% of the time, but rate-0.27 LDPC cleans it up; the uncoded
    # 48-bit BPSK header (same as the reference) is the limiting factor
    # below this point.
    noise_v = np.sqrt(sig / 10 ** 0.6)
    noisy = channel.awgn(jax.random.PRNGKey(2), out.samples, noise_v)
    rx = receiver.rx_frames(rxp, noisy)
    ok = np.asarray(rx.crc_ok)
    assert ok.mean() >= 0.75, (ok, np.asarray(rx.snr_db))
    np.testing.assert_array_equal(np.asarray(rx.payload)[ok], payload[ok])
    # BP iteration telemetry is wired: with the 2-pass equalizer most
    # frames' LLRs are clean enough that BP early-exits at iteration 0,
    # but the noisiest frames still show nonzero iterations
    assert float(jnp.max(rx.avg_iters)) > 0


def test_fec_partial_payload_frames():
    """Partially filled FEC frames (the pack_pdus -> FEC pipeline's last
    frame) must decode with the correct payload length (regression: the
    header used to advertise full-capacity tb_payload)."""
    cfg, rxcfg, fec, txp, rxp = _setup()
    rng = np.random.RandomState(4)
    B = 4
    cnst = np.full(B, 2, np.int32)
    plen = np.array([5, 1, 17, 0], np.int32)
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(0),
    )
    rx = receiver.rx_frames(rxp, out.samples)
    assert bool(jnp.all(rx.crc_ok)), np.asarray(rx.crc_ok)
    np.testing.assert_array_equal(np.asarray(rx.payload_len), plen)
    np.testing.assert_array_equal(np.asarray(rx.payload), payload)
