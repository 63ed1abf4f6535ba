"""Multi-code FEC bank: per-frame LDPC code selection in one jitted
graph (ref holds a 1-indexed code vector and switches per TB,
ldpc_enc.cc:21-30, fec_frame_bvb_impl.cc:178-201)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
from gr_dtl_jax.models import fec_chain
from gr_dtl_jax.ops import constellation as cn

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    return alist_mod.load_alist(os.path.join(HERE, "examples", name))


def _roundtrip(fec, B, rng, fec_id, cnst):
    bps = np.asarray(cn.BITS_PER_SYMBOL)[cnst]
    ub = np.asarray(fec["user_bytes_tab2"])[fec_id, bps]
    maxb = fec["max_payload_bytes"]
    payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])
    frame_bits, tbp = fec_chain.fec_frame_build(
        fec, jnp.asarray(payload), jnp.asarray(ub.astype(np.int32)),
        jnp.asarray(cnst), fec_id=jnp.asarray(fec_id))
    # noiseless channel: perfect LLRs from the bits
    llrs = (1.0 - 2.0 * frame_bits.astype(jnp.float32)) * 8.0
    out = fec_chain.fec_frame_decode(
        fec, llrs, jnp.asarray(cnst), jnp.asarray(tbp),
        fec_id=jnp.asarray(fec_id))
    return payload, ub, out


def test_mixed_code_batch_exact_recovery():
    cfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    fec = fec_chain.build_fec(
        cfg, [_load("n_0100_k_0027.alist"), _load("n_0300_k_0152.alist")])
    assert fec["n_codes"] == 2
    rng = np.random.RandomState(0)
    B = 16
    fec_id = rng.randint(1, 3, B).astype(np.int32)
    cnst = rng.randint(1, 5, B).astype(np.int32)
    payload, ub, out = _roundtrip(fec, B, rng, fec_id, cnst)
    ok = np.asarray(out.crc_ok)
    assert ok.all(), np.argwhere(~ok)
    pay = np.asarray(out.payload)
    plen = np.asarray(out.payload_len)
    for i in range(B):
        assert plen[i] == ub[i]
        np.testing.assert_array_equal(pay[i, : ub[i]], payload[i, : ub[i]])


def test_bank_of_one_matches_single_code_path():
    """fec_id=ones through the bank path == fec_id=None legacy path."""
    cfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    fec = fec_chain.build_fec(cfg, _load("n_0100_k_0027.alist"))
    rng = np.random.RandomState(1)
    B = 8
    cnst = rng.randint(1, 5, B).astype(np.int32)
    bps = np.asarray(cn.BITS_PER_SYMBOL)[cnst]
    ub = np.asarray(fec["user_bytes_tab"])[bps].astype(np.int32)
    maxb = fec["max_payload_bytes"]
    payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])
    fb_legacy, tb_legacy = fec_chain.fec_frame_build(
        fec, jnp.asarray(payload), jnp.asarray(ub), jnp.asarray(cnst))
    fb_bank, tb_bank = fec_chain.fec_frame_build(
        fec, jnp.asarray(payload), jnp.asarray(ub), jnp.asarray(cnst),
        fec_id=jnp.ones(B, jnp.int32))
    np.testing.assert_array_equal(np.asarray(fb_legacy), np.asarray(fb_bank))
    np.testing.assert_array_equal(np.asarray(tb_legacy), np.asarray(tb_bank))
    llrs = (1.0 - 2.0 * fb_legacy.astype(jnp.float32)) * 8.0
    out_legacy = fec_chain.fec_frame_decode(
        fec, llrs, jnp.asarray(cnst), jnp.asarray(tb_legacy))
    out_bank = fec_chain.fec_frame_decode(
        fec, llrs, jnp.asarray(cnst), jnp.asarray(tb_bank),
        fec_id=jnp.ones(B, jnp.int32))
    np.testing.assert_array_equal(np.asarray(out_legacy.payload),
                                  np.asarray(out_bank.payload))
    assert np.asarray(out_bank.crc_ok).all()


@pytest.mark.slow
def test_mixed_code_ofdm_loopback():
    """Full OFDM chain with per-frame code selection announced in the
    header's fec_scheme field: TX -> AWGN -> RX, exact recovery."""
    from gr_dtl_jax.models import receiver, transmitter
    from gr_dtl_jax.ops import channel

    Hs = [_load("n_0100_k_0027.alist"), _load("n_0300_k_0152.alist")]
    txcfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10, fec=True)
    fec = fec_chain.build_fec(txcfg, Hs)
    txp = transmitter.build_tx(txcfg, fec)
    rxp = receiver.build_rx(rxcfg, fec)

    rng = np.random.RandomState(3)
    B = 8
    fec_id = np.array([1, 2, 2, 1, 1, 2, 1, 2], np.int32)
    cnst = rng.randint(1, 5, B).astype(np.int32)
    bps = np.asarray(cn.BITS_PER_SYMBOL)[cnst]
    ub = np.asarray(fec["user_bytes_tab2"])[fec_id, bps].astype(np.int32)
    maxb = fec["max_payload_bytes"]
    payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])

    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(ub), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(0), fec_id=jnp.asarray(fec_id))
    sig = float(np.mean(np.abs(np.asarray(out.samples)) ** 2))
    frames = channel.awgn(jax.random.PRNGKey(1), out.samples,
                          float(np.sqrt(sig / 10 ** 2.6)))
    rx = receiver.rx_frames(rxp, frames)
    ok = np.asarray(rx.crc_ok)
    assert ok.all(), np.argwhere(~ok)
    pay = np.asarray(rx.payload)
    plen = np.asarray(rx.payload_len)
    for i in range(B):
        assert plen[i] == ub[i], (i, plen[i], ub[i])
        np.testing.assert_array_equal(pay[i, : ub[i]], payload[i, : ub[i]])


def test_mixed_code_noisy_decode():
    """Mixed codes survive moderate LLR noise (BP actually iterating)."""
    cfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    fec = fec_chain.build_fec(
        cfg, [_load("n_0100_k_0027.alist"), _load("n_0300_k_0152.alist")])
    rng = np.random.RandomState(2)
    B = 8
    fec_id = np.array([1, 2] * 4, np.int32)
    cnst = np.full(B, 2, np.int32)  # QPSK
    bps = np.asarray(cn.BITS_PER_SYMBOL)[cnst]
    ub = np.asarray(fec["user_bytes_tab2"])[fec_id, bps]
    maxb = fec["max_payload_bytes"]
    payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])
    frame_bits, tbp = fec_chain.fec_frame_build(
        fec, jnp.asarray(payload), jnp.asarray(ub.astype(np.int32)),
        jnp.asarray(cnst), fec_id=jnp.asarray(fec_id))
    sgn = 1.0 - 2.0 * np.asarray(frame_bits, np.float32)
    llrs = sgn * 3.0 + rng.randn(*sgn.shape).astype(np.float32) * 1.0
    out = fec_chain.fec_frame_decode(
        fec, jnp.asarray(llrs), jnp.asarray(cnst), jnp.asarray(tbp),
        fec_id=jnp.asarray(fec_id))
    ok = np.asarray(out.crc_ok)
    assert ok.all(), np.argwhere(~ok)
    assert np.asarray(out.avg_iters).max() > 0  # BP really ran
    pay = np.asarray(out.payload)
    for i in range(B):
        np.testing.assert_array_equal(pay[i, : ub[i]], payload[i, : ub[i]])


def test_decode_bank_mm_matches_gather_form():
    """The dense matmul-form bank decoder must agree with the gather
    form on hard bits, convergence, and iteration counts."""
    from gr_dtl_jax.ops import ldpc

    Hs = [np.asarray(_load("n_0100_k_0027.alist")),
          np.asarray(_load("n_0300_k_0152.alist"))]
    bank = ldpc.build_ldpc_bank(Hs)
    rng = np.random.RandomState(5)
    B = 32
    code_idx = rng.randint(1, 3, B).astype(np.int32)
    Kmax, Nmax, Mmax = bank["Kmax"], bank["Nmax"], bank["Mmax"]
    msgs = np.zeros((B, Kmax), np.float32)
    for i in range(B):
        k = int(bank["k_tab"][code_idx[i]])
        msgs[i, :k] = rng.randint(0, 2, k)
    cws = np.asarray(ldpc.encode_bank(jnp.asarray(msgs),
                                      jnp.asarray(code_idx), bank))
    llr = (1.0 - 2.0 * cws.astype(np.float32)) * 3.0
    llr += rng.randn(B, Nmax).astype(np.float32) * 0.9
    # pin slots outside each code's graph like the decode path does
    for i in range(B):
        m = int(bank["m_tab"][code_idx[i]])
        k = int(bank["k_tab"][code_idx[i]])
        llr[i, m:Mmax] = ldpc.SHORTENED_LLR
        llr[i, Mmax + k:] = ldpc.SHORTENED_LLR
    h_g, it_g, ok_g = ldpc.decode_bank(jnp.asarray(llr),
                                       jnp.asarray(code_idx), bank, 15)
    h_m, it_m, ok_m = ldpc.decode_bank_mm(jnp.asarray(llr),
                                          jnp.asarray(code_idx), bank, 15)
    assert np.asarray(ok_g).mean() > 0.8  # the point must be decodable
    np.testing.assert_array_equal(np.asarray(ok_g), np.asarray(ok_m))
    np.testing.assert_array_equal(np.asarray(it_g), np.asarray(it_m))
    # hard bits must agree wherever BP converged
    conv = np.asarray(ok_g)
    np.testing.assert_array_equal(np.asarray(h_g)[conv], np.asarray(h_m)[conv])
