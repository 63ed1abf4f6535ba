"""FEC chain without OFDM: frame bits -> symbols -> soft LLRs -> TB
decode; exact recovery for all constellations x 2 codes (mirrors
qa_ofdm_adaptive_fec.py:71-171)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
from gr_dtl_jax.ops import constellation as cn, repack
from gr_dtl_jax.models import fec_chain

ALISTS = [
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "n_0100_k_0027.alist"),
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "n_0100_k_0023.alist"),
]


@pytest.mark.parametrize("alist_path", ALISTS)
@pytest.mark.parametrize("frame_length", [10, 20])
def test_fec_chain_noiseless(alist_path, frame_length):
    cfg = cfgmod.make_tx_config(None, frame_length=frame_length, fec=True)
    H = alist_mod.load_alist(alist_path)
    fec = fec_chain.build_fec(cfg, H)
    rng = np.random.RandomState(0)

    B = 4
    cnst = np.array([1, 2, 3, 4], np.int32)
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    plen = np.zeros(B, np.int32)
    for i in range(B):
        plen[i] = fec["user_bytes_tab"][int(cn.BITS_PER_SYMBOL[cnst[i]])]
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])

    frame_bits, tb_len = fec_chain.fec_frame_build(
        fec, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst)
    )

    # bits -> symbols (1 -> bps repack, LSB first) -> map -> soft demap
    bits_u8 = (np.asarray(frame_bits) & 1).astype(np.uint8)
    n_syms = cfg.frame_capacity_symbols
    packed = repack.bits_to_bytes(jnp.asarray(bits_u8))
    bps = jnp.asarray(cn.BITS_PER_SYMBOL)[jnp.asarray(cnst)]
    syms = repack.bytes_to_symbols(packed, bps, n_syms)
    pts = cn.map_symbols(syms, jnp.asarray(cnst)[:, None])
    llr_bits = cn.soft_llrs(pts, jnp.asarray(cnst)[:, None], jnp.full((B,), 0.05))
    # flatten per-symbol LLRs back to the frame bit stream (LSB-first)
    llrs = np.zeros((B, fec["max_frame_bits"]), np.float32)
    ln = np.asarray(llr_bits)
    for i in range(B):
        b = int(cn.BITS_PER_SYMBOL[cnst[i]])
        llrs[i, : n_syms * b] = ln[i, :, :b].reshape(-1)

    out = fec_chain.fec_frame_decode(fec, jnp.asarray(llrs), jnp.asarray(cnst))
    assert bool(jnp.all(out.fec_ok)), np.asarray(out.fec_ok)
    assert bool(jnp.all(out.crc_ok)), np.asarray(out.crc_ok)
    np.testing.assert_array_equal(np.asarray(out.payload_len), plen)
    np.testing.assert_array_equal(np.asarray(out.payload), payload)


def test_fec_chain_noisy_bpsk():
    """Coded BPSK frame survives noise that would break uncoded CRC."""
    cfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    H = alist_mod.load_alist(ALISTS[0])
    fec = fec_chain.build_fec(cfg, H)
    rng = np.random.RandomState(1)
    B = 8
    cnst = np.full(B, 1, np.int32)
    plen = np.full(B, int(fec["user_bytes_tab"][1]), np.int32)
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    frame_bits, _ = fec_chain.fec_frame_build(
        fec, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst)
    )
    x = 1.0 - 2.0 * np.asarray(frame_bits).astype(np.float32)
    sigma = 0.55  # ~5.2 dB SNR, raw BER ~3.5%
    y = x + sigma * rng.randn(*x.shape)
    nbits = cfg.frame_capacity_symbols  # bps=1
    llrs = np.zeros_like(y)
    llrs[:, :nbits] = 2.0 * y[:, :nbits] / sigma**2
    out = fec_chain.fec_frame_decode(fec, jnp.asarray(llrs, dtype=jnp.float32),
                                     jnp.asarray(cnst))
    assert np.asarray(out.crc_ok).mean() >= 0.9
    ok = np.asarray(out.crc_ok)
    np.testing.assert_array_equal(np.asarray(out.payload)[ok], payload[ok])
    assert float(jnp.max(out.avg_iters)) > 0
