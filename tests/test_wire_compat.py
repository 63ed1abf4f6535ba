"""Wire-format compatibility scaffold (utils/wire_compat).

The reference transmits constants that come out of a gr-digital
install (constellation label tables, ``_make_sync_word1/2`` PN —
ref ofdm_adaptive_config.py:33-36, constellation.cc:18-24).  No
gnuradio exists on this box, so true golden-bit interop tests are
*gated on the presence of an extracted constants file*
(examples/wire_constants.json, produced by
tools/extract_gr_constants.py on any machine with GNU Radio).

What always runs here:
 - schema round-trip: native constants dumped to the wire schema,
   re-loaded, re-activated — loopback stays byte-exact (activation
   plumbing is a behavioral no-op for our own constants);
 - foreign-constants loopback: a deliberately NON-Gray relabeled
   constellation set + different sync PN is installed and the full
   TX -> channel -> RX chain still recovers byte-exactly — proving the
   constants actually flow into both ends (mapper, hard + soft
   decisions, sync correlator, channel estimator) and the generic
   table decision paths are correct.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.ops import channel, constellation as cn
from gr_dtl_jax.utils import config as cfgmod, wire_compat

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRACTED = os.path.join(HERE, "examples", "wire_constants.json")


@pytest.fixture
def clean_wire_state():
    yield
    wire_compat.deactivate()


def _loopback_ok(frame_length=10, B=4, ctype=4, snr_db=30):
    """Build fresh models under the CURRENT constants; return True if a
    padded AWGN loopback recovers every byte."""
    from gr_dtl_jax.models import receiver, transmitter

    cfg = cfgmod.make_tx_config(None, frame_length=frame_length)
    rxcfg = cfgmod.make_rx_config(None, frame_length=frame_length)
    txp = transmitter.build_tx(cfg)
    rxp = receiver.build_rx(rxcfg)
    rng = np.random.RandomState(7)
    cnst = np.full((B,), ctype, np.int32)
    maxb = cfg.max_frame_bytes()
    payload = np.zeros((B, maxb), np.uint8)
    plen = np.zeros((B,), np.int32)
    for i in range(B):
        cap = cfg.frame_bytes(int(cn.BITS_PER_SYMBOL[ctype])) - 4
        plen[i] = cap
        payload[i, :cap] = rng.randint(0, 256, cap)
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(0))
    stream = out.samples.reshape(-1)
    stream = jnp.concatenate([jnp.zeros(301, jnp.complex64), stream,
                              jnp.zeros(400, jnp.complex64)])
    sig_pow = float(jnp.mean(jnp.abs(out.samples) ** 2))
    nv = np.sqrt(sig_pow / 10 ** (snr_db / 10))
    stream = channel.awgn(jax.random.PRNGKey(2), stream, nv)
    frames, _ = receiver.detect_and_extract(stream, rxcfg, B)
    rx = receiver.rx_frames(rxp, frames)
    return (bool(jnp.all(rx.header_ok)) and bool(jnp.all(rx.crc_ok))
            and np.array_equal(np.asarray(rx.payload), payload))


def test_dump_native_schema_round_trip(tmp_path, clean_wire_state):
    """Native constants -> JSON -> load -> activate: still byte-exact."""
    d = wire_compat.dump_native()
    path = tmp_path / "native_constants.json"
    path.write_text(json.dumps(d))
    consts = wire_compat.load(str(path))
    assert consts["fft_len"] == 64
    assert set(consts["points"]) == {1, 2, 3, 4}
    wire_compat.activate(consts)
    # our own constants: tables identical, sync words identical
    np.testing.assert_allclose(cn.POINTS, cn._DEFAULT_POINTS)
    assert _loopback_ok()


def _foreign_constants():
    """A constants set deliberately unlike the native one: non-Gray
    relabeled QPSK/8PSK/QAM16 and a different sync PN (stand-in for the
    gr-digital layouts until a real extraction lands)."""
    d = wire_compat.dump_native()
    for name in ("qpsk", "psk8", "qam16"):
        pts = d["constellations"][name]
        # rotate the label->point assignment: label i gets point i+1
        d["constellations"][name] = pts[1:] + pts[:1]
    rng = np.random.RandomState(99)
    act = sorted(set(cfgmod.DEFAULT_OCCUPIED_CARRIERS)
                 | set(cfgmod.DEFAULT_PILOT_CARRIERS))
    w1 = np.zeros(64, np.complex64)
    w2 = np.zeros(64, np.complex64)
    for c in act:
        if c % 2 == 0 and c != 0:
            w1[c + 32] = np.sqrt(2.0) * (1.0 - 2.0 * rng.randint(2))
        w2[c + 32] = 1.0 - 2.0 * rng.randint(2)
    d["sync_word1"] = [[float(v.real), float(v.imag)] for v in w1]
    d["sync_word2"] = [[float(v.real), float(v.imag)] for v in w2]
    return d


@pytest.mark.parametrize("ctype", [2, 3, 4])
def test_foreign_constants_loopback(tmp_path, clean_wire_state, ctype):
    path = tmp_path / "foreign.json"
    path.write_text(json.dumps(_foreign_constants()))
    cfg = cfgmod.make_tx_config({"wire_compat": str(path)},
                                frame_length=10)
    # activation happened inside make_tx_config (cfg.wire_compat)
    assert cn.TABLE_MODE
    assert cfg.wire_compat == str(path)
    # the installed table really is foreign (rotated labels)
    assert not np.allclose(cn.POINTS[2, :4], cn._DEFAULT_POINTS[2, :4])
    assert _loopback_ok(ctype=ctype)


def test_foreign_constants_coded_loopback(tmp_path, clean_wire_state):
    """FEC path under foreign constants: the soft demap must follow the
    foreign label tables (generic table LLRs), or the LDPC decoder gets
    scrambled bit mappings and every TB fails."""
    import jax.numpy as jnp
    from gr_dtl_jax.models import fec_chain, receiver, transmitter
    from gr_dtl_jax.utils import alist as alist_mod

    path = tmp_path / "foreign.json"
    path.write_text(json.dumps(_foreign_constants()))
    wire_compat.activate(str(path))
    cfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10, fec=True)
    H = alist_mod.load_alist(os.path.join(HERE, "examples",
                                          "n_0100_k_0027.alist"))
    fec = fec_chain.build_fec(cfg, H)
    txp = transmitter.build_tx(cfg, fec)
    rxp = receiver.build_rx(rxcfg, fec)
    rng = np.random.RandomState(11)
    B = 4
    ctype = 4  # QAM16: the most label-sensitive table
    cnst = np.full((B,), ctype, np.int32)
    nbytes = int(fec["user_bytes_tab"][4])
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    plen = np.full((B,), nbytes, np.int32)
    for i in range(B):
        payload[i, :nbytes] = rng.randint(0, 256, nbytes)
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(0))
    stream = jnp.concatenate([jnp.zeros(211, jnp.complex64),
                              out.samples.reshape(-1),
                              jnp.zeros(400, jnp.complex64)])
    sig = float(jnp.mean(jnp.abs(out.samples) ** 2))
    stream = channel.awgn(jax.random.PRNGKey(4), stream,
                          float(np.sqrt(sig / 10 ** (25 / 10))))
    frames, _ = receiver.detect_and_extract(stream, rxcfg, B)
    rx = receiver.rx_frames(rxp, frames)
    assert bool(jnp.all(rx.header_ok))
    assert bool(jnp.all(rx.crc_ok)), "coded TBs failed under wire tables"
    np.testing.assert_array_equal(
        np.asarray(rx.payload)[:, :nbytes], payload[:, :nbytes])


def test_foreign_soft_path_matches_table_oracle(clean_wire_state):
    """In wire mode, soft_llrs must be the generic table reduction."""
    d = _foreign_constants()
    consts = {
        "fft_len": 64,
        "points": {ty: np.asarray(
            [complex(re, im) for re, im in d["constellations"][nm]],
            np.complex64)
            for nm, ty in (("bpsk", 1), ("qpsk", 2), ("psk8", 3),
                           ("qam16", 4))},
        "sync_word1": np.zeros(64, np.complex64),
        "sync_word2": np.zeros(64, np.complex64),
    }
    wire_compat.activate(consts)
    rng = np.random.RandomState(0)
    y = (rng.randn(4, 32) + 1j * rng.randn(4, 32)).astype(np.complex64)
    cid = np.array([1, 2, 3, 4], np.int32)
    nv = np.full(4, 0.3, np.float32)
    got = cn.soft_llrs(jnp.asarray(y), jnp.asarray(cid), jnp.asarray(nv))
    want = cn.soft_llrs_table(jnp.asarray(y), jnp.asarray(cid),
                              jnp.asarray(nv))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want))
    hard = cn.hard_decision(jnp.asarray(y), jnp.asarray(cid))
    idx_t, _ = cn.nearest_point_table(jnp.asarray(y), jnp.asarray(cid))
    np.testing.assert_array_equal(np.asarray(hard), np.asarray(idx_t))


# ---------------------------------------------------------------------------
# golden-bit interop tests: activate the day a real extraction lands
# ---------------------------------------------------------------------------

needs_extraction = pytest.mark.skipif(
    not os.path.exists(EXTRACTED),
    reason="no extracted gr constants in tree "
           "(run tools/extract_gr_constants.py on a machine with "
           "GNU Radio and commit examples/wire_constants.json)")


@needs_extraction
def test_extracted_constants_loopback(clean_wire_state):
    """Full loopback under the real gr-digital constants."""
    wire_compat.activate(EXTRACTED)
    for ctype in (1, 2, 3, 4):
        assert _loopback_ok(ctype=ctype)


@needs_extraction
def test_extracted_qpsk_normalization(clean_wire_state):
    """The reference scales QPSK x0.5 (constellation.cc:18-24)."""
    consts = wire_compat.load(EXTRACTED)
    r = np.abs(consts["points"][2])
    np.testing.assert_allclose(r, 0.5, atol=1e-5)


def test_foreign_constants_streaming_session(tmp_path, clean_wire_state):
    """Always-on shape under foreign constants: a StreamRx session fed
    chunk by chunk (carried tail/lock state, mixed MCS, mid-block frame
    starts) recovers every byte with the relabeled tables + foreign
    sync PN installed — the drop-in proven for the daemon shape, not
    just batch loopback."""
    from gr_dtl_jax.models import session, transmitter

    path = tmp_path / "foreign.json"
    path.write_text(json.dumps(_foreign_constants()))
    wire_compat.activate(str(path))
    assert cn.TABLE_MODE
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    F, n_blocks = 4, 4
    B = (n_blocks - 1) * F
    rng = np.random.RandomState(21)
    cnst = rng.randint(1, 5, size=B).astype(np.int32)
    maxb = txcfg.max_frame_bytes()
    payload = np.zeros((B, maxb), np.uint8)
    plen = np.zeros(B, np.int32)
    for i in range(B):
        plen[i] = txcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst[i]])) - 4
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(5))
    rx = session.StreamRx(cfg, frames_per_block=F)
    blk = rx.block_samples
    sig = float(jnp.mean(jnp.abs(out.samples) ** 2))
    stream = np.concatenate([
        np.zeros(317, np.complex64),
        np.asarray(out.samples).reshape(-1),
        np.zeros(n_blocks * blk, np.complex64)])[: n_blocks * blk]
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(6), jnp.asarray(stream),
        float(np.sqrt(sig / 10 ** 3))))
    decoded = {}
    for b in range(n_blocks):
        outb, valid = rx.process(stream[b * blk:(b + 1) * blk])
        ok = np.asarray(outb.crc_ok) & valid
        nos = np.asarray(outb.frame_no)
        pays = np.asarray(outb.payload)
        lens = np.asarray(outb.payload_len)
        for i in np.nonzero(ok)[0]:
            decoded[int(nos[i])] = pays[i, : lens[i]].tobytes()
    assert len(decoded) == B, sorted(decoded)
    for i in range(B):
        assert decoded[i] == payload[i, : plen[i]].tobytes()


def test_foreign_constants_code_bank(tmp_path, clean_wire_state):
    """Multi-code LDPC bank under foreign constants: per-frame code
    selection + the generic-table soft demap must compose (a scrambled
    label table would corrupt every LLR stream into the bank decoder)."""
    from gr_dtl_jax.models import fec_chain, receiver, transmitter
    from gr_dtl_jax.utils import alist as alist_mod

    path = tmp_path / "foreign.json"
    path.write_text(json.dumps(_foreign_constants()))
    wire_compat.activate(str(path))
    cfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10, fec=True)
    Hs = [alist_mod.load_alist(os.path.join(HERE, "examples", n))
          for n in ("n_0100_k_0027.alist", "n_0300_k_0152.alist")]
    fec = fec_chain.build_fec(cfg, Hs)
    assert fec["n_codes"] == 2
    txp = transmitter.build_tx(cfg, fec)
    rxp = receiver.build_rx(rxcfg, fec)
    rng = np.random.RandomState(31)
    B = 8
    cnst = rng.randint(2, 5, B).astype(np.int32)  # label-sensitive MCS
    fec_id = rng.randint(1, 3, B).astype(np.int32)
    bps = np.asarray(cn.BITS_PER_SYMBOL)[cnst]
    ub = np.asarray(fec["user_bytes_tab2"])[fec_id, bps].astype(np.int32)
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    for i in range(B):
        payload[i, : ub[i]] = rng.randint(0, 256, ub[i])
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(ub), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(1), fec_id=jnp.asarray(fec_id))
    stream = jnp.concatenate([jnp.zeros(223, jnp.complex64),
                              out.samples.reshape(-1),
                              jnp.zeros(400, jnp.complex64)])
    sig = float(jnp.mean(jnp.abs(out.samples) ** 2))
    stream = channel.awgn(jax.random.PRNGKey(8), stream,
                          float(np.sqrt(sig / 10 ** (25 / 10))))
    frames, _ = receiver.detect_and_extract(stream, rxcfg, B)
    rx = receiver.rx_frames(rxp, frames)
    assert bool(jnp.all(rx.header_ok))
    assert bool(jnp.all(rx.crc_ok)), "bank TBs failed under wire tables"
    pay = np.asarray(rx.payload)
    for i in range(B):
        np.testing.assert_array_equal(pay[i, : ub[i]], payload[i, : ub[i]])
