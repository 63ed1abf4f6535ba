"""Multi-frame transport blocks: TBs spanning W=2 and W=3 frames through
the full OFDM chain (the reference tb_decoder's cross-frame reassembly,
here as aligned W-frame groups)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
from gr_dtl_jax.ops import channel, constellation as cn
from gr_dtl_jax.models import fec_chain, receiver, transmitter

ALIST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "n_0100_k_0027.alist")


def _group_payload(fec, G, cnst_per_group, rng):
    W = fec["W"]
    B = G * W
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    plen = np.zeros(B, np.int32)
    cnst = np.zeros(B, np.int32)
    for g in range(G):
        c = cnst_per_group[g]
        cnst[g * W : (g + 1) * W] = c
        nb = int(fec["user_bytes_tab"][int(cn.BITS_PER_SYMBOL[c])])
        plen[g * W] = nb
        payload[g * W, :nb] = rng.randint(0, 256, nb)
    return payload, plen, cnst


@pytest.mark.parametrize("W", [2, 3])
def test_multiframe_tb_chain(W):
    cfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    H = alist_mod.load_alist(ALIST)
    fec = fec_chain.build_fec(cfg, H, tb_frames=W)
    rng = np.random.RandomState(W)
    G = 4
    cnst_groups = [1, 2, 3, 4]
    payload, plen, cnst = _group_payload(fec, G, cnst_groups, rng)

    frame_bits, tb_payload = fec_chain.fec_frame_build(
        fec, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst)
    )
    assert frame_bits.shape == (G * W, fec["max_frame_bits"])
    # a W-frame group carries more user bytes than W independent frames
    fec1 = fec_chain.build_fec(cfg, H, tb_frames=1)
    assert fec["user_bytes_tab"][4] > W // 2 * fec1["user_bytes_tab"][4]

    # noiseless bit-level decode
    llrs = (1.0 - 2.0 * np.asarray(frame_bits)).astype(np.float32) * 9.0
    # zero out bits beyond each frame's real count
    for i in range(G * W):
        nb = int(fec["frame_bits_tab"][int(cn.BITS_PER_SYMBOL[cnst[i]])])
        llrs[i, nb:] = 0.0
    out = fec_chain.fec_frame_decode(fec, jnp.asarray(llrs), jnp.asarray(cnst))
    assert bool(jnp.all(out.fec_ok)) and bool(jnp.all(out.crc_ok))
    np.testing.assert_array_equal(np.asarray(out.payload_len), plen)
    np.testing.assert_array_equal(np.asarray(out.payload), payload)


def test_multiframe_tb_ofdm_loopback():
    """W=2 TBs through the full modulated chain with noise."""
    W = 2
    cfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10, fec=True)
    H = alist_mod.load_alist(ALIST)
    fec = fec_chain.build_fec(cfg, H, tb_frames=W)
    txp = transmitter.build_tx(cfg, fec)
    rxp = receiver.build_rx(rxcfg, fec)
    rng = np.random.RandomState(0)
    G = 4
    payload, plen, cnst = _group_payload(fec, G, [2, 2, 1, 2], rng)
    B = G * W
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(0),
    )
    sig = float(jnp.mean(jnp.abs(out.samples) ** 2))
    noisy = channel.awgn(jax.random.PRNGKey(1), out.samples,
                         float(np.sqrt(sig / 10 ** 1.2)))  # 12 dB
    rx = receiver.rx_frames(rxp, noisy)
    assert bool(jnp.all(rx.header_ok))
    assert bool(jnp.all(rx.crc_ok)), np.asarray(rx.crc_ok)
    np.testing.assert_array_equal(np.asarray(rx.payload), payload)
    np.testing.assert_array_equal(np.asarray(rx.payload_len), plen)
