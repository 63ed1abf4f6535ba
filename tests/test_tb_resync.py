"""Loss-resilient transport-block reassembly.

The reference's tb_decoder re-anchors on the header's tb_no/tb_offset
after a lost frame (tb_decoder.cc:90-138) so one lost frame costs one
TB, not stream-long misalignment.  These tests drop/corrupt frames
mid-TB in a continuous FEC stream and require every other TB to decode.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
from gr_dtl_jax.ops import channel, constellation as cn
from gr_dtl_jax.models import fec_chain, session, transmitter
import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIST = os.path.join(HERE, "examples", "n_0100_k_0027.alist")


def test_tb_reassemble_unit():
    """Scan-level semantics: slot writes by offset, emission on new
    tb_no, lost frames leave erased slots without shifting later TBs."""
    cfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    H = alist_mod.load_alist(ALIST)
    fec = fec_chain.build_fec(cfg, H, tb_frames=2)
    fb = int(fec["frame_bits_tab"][1])  # BPSK frame bits
    maxF = fec["max_frame_bits"]

    # stream of 6 frames = 3 TBs; frame 3 (TB1 slot 1) is lost (ok=False)
    F = 6
    llrs = np.zeros((F, maxF), np.float32)
    for i in range(F):
        llrs[i, :fb] = float(i + 1)  # marker value per frame
    tb_no = np.array([0, 0, 1, 1, 2, 2], np.int32)
    tb_off = np.array([0, fb, 0, fb, 0, fb], np.int32)
    ok = np.array([1, 1, 1, 0, 1, 1], bool)
    cnst = np.ones(F, np.int32)
    plen = np.full(F, int(fec["tb_payload_tab"][1]), np.int32)
    fid = np.ones(F, np.int32)

    st = fec_chain.init_tb_state(fec)
    st, em = fec_chain.tb_reassemble(
        st, jnp.asarray(llrs), jnp.asarray(tb_no), jnp.asarray(tb_off),
        jnp.asarray(cnst), jnp.asarray(plen), jnp.asarray(fid),
        jnp.asarray(ok), fec)
    valid = np.asarray(em["valid"])
    # TB0 emitted when frame 2 (tb_no 1) arrives; TB1 when frame 4 does
    assert list(np.nonzero(valid)[0]) == [2, 4]
    assert list(np.asarray(em["tb_no"])[valid]) == [0, 1]
    e = np.asarray(em["llrs"])
    # TB0: both slots filled with markers 1 and 2
    assert e[2, 0, 0] == 1.0 and e[2, 1, 0] == 2.0
    # TB1: slot 0 has marker 3; slot 1 erased (frame 3 lost) -> LLR 0
    assert e[4, 0, 0] == 3.0 and np.all(e[4, 1] == 0.0)
    # TB2 still buffered in the carry, correctly anchored
    assert int(st.tb_no) == 2
    assert np.asarray(st.llrs)[0, 0] == 5.0 and np.asarray(st.llrs)[1, 0] == 6.0


@pytest.mark.slow
def test_stream_rx_tb_loss_resync():
    """StreamRx FEC session (W=2): corrupt one frame mid-TB; every TB
    not touched by the corruption must still decode exactly."""
    W = 2
    txcfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10, fec=True)
    H = alist_mod.load_alist(ALIST)
    fec = fec_chain.build_fec(txcfg, H, tb_frames=W)
    txp = transmitter.build_tx(txcfg, fec)

    G, F = 8, 4  # 8 TBs = 16 frames = 4 blocks
    B = G * W
    rng = np.random.RandomState(42)
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    plen = np.zeros(B, np.int32)
    cnst = np.full(B, 2, np.int32)  # QPSK throughout
    nb = int(fec["user_bytes_tab"][2])
    for g in range(G):
        plen[g * W] = nb
        payload[g * W, :nb] = rng.randint(0, 256, nb)
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(0))
    samples = np.asarray(out.samples)  # [B, frame_samples]
    P = rxcfg.frame_samples
    sig = float(np.mean(np.abs(samples) ** 2))

    # corrupt frame 5 (second frame of TB 2): replace with noise at the
    # same power, so timing for every later frame is untouched but the
    # frame itself is undetectable
    lost = 5
    noise_k = jax.random.PRNGKey(99)
    samples = samples.copy()
    samples[lost] = np.asarray(
        (jax.random.normal(noise_k, (P,)) + 1j * jax.random.normal(
            jax.random.split(noise_k)[0], (P,))) * np.sqrt(sig / 2)
    ).astype(np.complex64)

    rx = session.StreamRx(rxcfg, frames_per_block=F, fec=fec)
    S = rx.block_samples
    stream = np.concatenate([samples.reshape(-1),
                             np.zeros(2 * S, np.complex64)])
    stream = stream[: (len(stream) // S) * S]
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(1), jnp.asarray(stream),
        float(np.sqrt(sig / 10 ** 3))))  # 30 dB

    got = {}
    for b in range(len(stream) // S):
        _outb, _valid, tb = rx.process(stream[b * S:(b + 1) * S])
        v = np.asarray(tb["valid"])
        okc = np.asarray(tb["crc_ok"])
        nos = np.asarray(tb["tb_no"])
        pays = np.asarray(tb["payload"])
        lens = np.asarray(tb["payload_len"])
        for i in np.nonzero(v)[0]:
            if okc[i]:
                got[int(nos[i])] = pays[i, : lens[i]].tobytes()
    tail = rx.flush_tb()
    if tail is not None and bool(tail["valid"][0]) and bool(tail["crc_ok"][0]):
        got[int(tail["tb_no"][0])] = bytes(
            np.asarray(tail["payload"])[0][: int(tail["payload_len"][0])])

    damaged = lost // W  # TB index hit by the corruption
    for g in range(G):
        if g == damaged:
            continue  # may or may not survive erasure decoding
        assert g in got, f"TB {g} never decoded (got {sorted(got)})"
        assert got[g] == payload[g * W, :nb].tobytes(), f"TB {g} mismatch"


@pytest.mark.slow
def test_stream_rx_tb_multi_loss_and_cnst_switch():
    """Two separate losses + a mid-stream constellation switch: the
    offset-keyed reassembly must stay aligned through both."""
    W = 3
    txcfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10, fec=True)
    H = alist_mod.load_alist(ALIST)
    fec = fec_chain.build_fec(txcfg, H, tb_frames=W)
    txp = transmitter.build_tx(txcfg, fec)

    G, F = 6, 6  # 6 TBs = 18 frames = 3 blocks
    B = G * W
    rng = np.random.RandomState(7)
    cnst_groups = [1, 1, 2, 2, 2, 1]
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    plen = np.zeros(B, np.int32)
    cnst = np.zeros(B, np.int32)
    for g in range(G):
        c = cnst_groups[g]
        cnst[g * W:(g + 1) * W] = c
        nb = int(fec["user_bytes_tab"][int(cn.BITS_PER_SYMBOL[c])])
        plen[g * W] = nb
        payload[g * W, :nb] = rng.randint(0, 256, nb)
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(2))
    samples = np.asarray(out.samples).copy()
    P = rxcfg.frame_samples
    sig = float(np.mean(np.abs(samples) ** 2))
    for j, lost in enumerate([4, 10]):  # TB1 slot 1, TB3 slot 1
        k = jax.random.PRNGKey(50 + j)
        samples[lost] = np.asarray(
            (jax.random.normal(k, (P,)) + 1j * jax.random.normal(
                jax.random.split(k)[0], (P,))) * np.sqrt(sig / 2)
        ).astype(np.complex64)

    rx = session.StreamRx(rxcfg, frames_per_block=F, fec=fec)
    S = rx.block_samples
    stream = np.concatenate([samples.reshape(-1),
                             np.zeros(2 * S, np.complex64)])
    stream = stream[: (len(stream) // S) * S]
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(3), jnp.asarray(stream),
        float(np.sqrt(sig / 10 ** 3))))

    got = {}
    for b in range(len(stream) // S):
        _o, _v, tb = rx.process(stream[b * S:(b + 1) * S])
        v = np.asarray(tb["valid"]) & np.asarray(tb["crc_ok"])
        for i in np.nonzero(v)[0]:
            got[int(np.asarray(tb["tb_no"])[i])] = np.asarray(
                tb["payload"])[i, : int(np.asarray(tb["payload_len"])[i])
            ].tobytes()
    tail = rx.flush_tb()
    if tail is not None and bool(tail["valid"][0]) and bool(tail["crc_ok"][0]):
        got[int(tail["tb_no"][0])] = bytes(
            np.asarray(tail["payload"])[0][: int(tail["payload_len"][0])])

    damaged = {4 // W, 10 // W}
    for g in range(G):
        if g in damaged:
            continue
        nb = int(fec["user_bytes_tab"][int(cn.BITS_PER_SYMBOL[cnst_groups[g]])])
        assert g in got, f"TB {g} never decoded (got {sorted(got)})"
        assert got[g] == payload[g * W, :nb].tobytes(), f"TB {g} mismatch"
