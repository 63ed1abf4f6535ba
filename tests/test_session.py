"""Continuous streaming receiver: chunked stream with frames straddling
block boundaries, each frame demodulated exactly once, in order."""

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.ops import channel, constellation as cn
from gr_dtl_jax.models import session, transmitter
import pytest


@pytest.mark.slow
def test_stream_rx_chunked():
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    F = 4
    n_blocks = 5
    B = F * n_blocks
    rng = np.random.RandomState(0)
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
        jax.random.PRNGKey(0),
    )
    rx = session.StreamRx(cfg, frames_per_block=F)
    S = rx.block_samples
    # frames start mid-block (offset 300) so every block boundary cuts
    # a frame; total stream padded to a whole number of blocks
    stream = np.concatenate([
        np.zeros(300, np.complex64),
        np.asarray(out.samples).reshape(-1),
        np.zeros((n_blocks + 1) * S, np.complex64),
    ])[: (n_blocks + 1) * S]
    sig = float(np.mean(np.abs(np.asarray(out.samples)) ** 2))
    stream = np.asarray(channel.awgn(jax.random.PRNGKey(1), jnp.asarray(stream),
                                     float(np.sqrt(sig / 10**3))))

    decoded = {}
    for b in range(n_blocks + 1):
        outb, valid = rx.process(stream[b * S : (b + 1) * S])
        ok = np.asarray(outb.crc_ok)
        nos = np.asarray(outb.frame_no)
        pays = np.asarray(outb.payload)
        lens = np.asarray(outb.payload_len)
        for i in range(F):
            if ok[i] and valid[i]:
                assert nos[i] not in decoded, f"frame {nos[i]} decoded twice"
                decoded[int(nos[i])] = pays[i, : lens[i]].tobytes()

    assert len(decoded) == B, (sorted(decoded), B)
    for i in range(B):
        assert decoded[i] == payload[i, : plen[i]].tobytes(), f"frame {i} mismatch"


def test_stream_tx_packing_and_empty_budget():
    """PDU packing honors whole-PDU/jumbo semantics; empty-frame budget
    ends the stream like the reference framer's WORK_DONE."""
    cfg = cfgmod.make_tx_config(None, frame_length=10, max_empty_frames=1)
    tx = session.StreamTx(cfg, frames_per_block=4)
    cap = tx._capacity()
    rng = np.random.RandomState(3)
    small = [rng.randint(0, 256, cap // 3).astype(np.uint8).tobytes()
             for _ in range(4)]
    jumbo = rng.randint(0, 256, 2 * cap + 5).astype(np.uint8).tobytes()
    for p in small[:2]:
        tx.send(p)
    tx.send(jumbo)
    for p in small[2:]:
        tx.send(p)

    infos = []
    while True:
        blk = tx.next_block()
        if blk is None:
            break
        samples, info = blk
        assert samples.shape == (tx.block_samples,)
        infos.append(info)
    plens = np.concatenate([i["payload_len"] for i in infos])
    # frame 0: two small PDUs packed together; then jumbo split 2 full +
    # remainder frame shared nothing (jumbo owns frames), then 2 smalls
    payload_stream = b"".join(small[:2]) + jumbo + b"".join(small[2:])
    got = []
    for i in infos:
        for f in range(4):
            if i["payload_len"][f]:
                got.append((i["frame_no"][f], i["payload_len"][f]))
    # whole-PDU packing: first data frame holds both small PDUs
    assert plens[0] == 2 * (cap // 3)
    # jumbo split: two full-capacity frames
    assert plens[1] == cap and plens[2] == cap
    # total bytes conserved
    assert int(plens.sum()) == len(payload_stream)
    # frames: [s0+s1], [jumbo cap], [jumbo cap], [jumbo tail], [s2+s3]
    n_data_frames = int((plens > 0).sum())
    assert n_data_frames == 5
    assert len(infos) >= 2 and all(infos[-1]["payload_len"] == 0)


def test_stream_tx_to_stream_rx_roundtrip():
    """Continuous TX session -> AWGN -> continuous RX session recovers
    every queued PDU byte."""
    txcfg = cfgmod.make_tx_config(None, frame_length=10, max_empty_frames=0)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10)
    F = 4
    tx = session.StreamTx(txcfg, frames_per_block=F, seed=7)
    cap = tx._capacity()
    rng = np.random.RandomState(5)
    pdus = [rng.randint(0, 256, rng.randint(10, cap + 200)).astype(np.uint8).tobytes()
            for _ in range(6)]
    for p in pdus:
        tx.send(p)
    rx = session.StreamRx(rxcfg, frames_per_block=F)
    sent = []
    blocks = []
    while True:
        blk = tx.next_block()
        if blk is None:
            break
        samples, info = blk
        for f in range(F):
            if info["payload_len"][f]:
                sent.append(bytes(
                    np.asarray(info["frame_bytes"])[f][: info["payload_len"][f]]
                    .astype(np.uint8)))
        blocks.append(samples)
    blocks.append(np.zeros(rx.block_samples, np.complex64))  # flush tail
    stream = np.concatenate(blocks)
    sig = float(np.mean(np.abs(stream[: len(blocks[0])]) ** 2))
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(2), jnp.asarray(stream), float(np.sqrt(sig / 10**3))))
    got = []
    for b in range(len(blocks)):
        outb, valid = rx.process(stream[b * rx.block_samples:(b + 1) * rx.block_samples])
        ok = np.asarray(outb.crc_ok) & valid
        for i in range(F):
            if ok[i] and np.asarray(outb.payload_len)[i]:
                got.append(bytes(np.asarray(outb.payload)[i][: np.asarray(outb.payload_len)[i]]))
    assert b"".join(got) == b"".join(sent) == b"".join(pdus)


def test_stream_tx_fec_roundtrip():
    """FEC-mode StreamTx: capacities come from the code tables; coded
    stream decodes exactly through a FEC StreamRx."""
    import os

    from gr_dtl_jax.utils import alist as alist_mod
    from gr_dtl_jax.models import fec_chain

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    H = alist_mod.load_alist(os.path.join(here, "examples",
                                          "n_0100_k_0027.alist"))
    txcfg = cfgmod.make_tx_config(None, frame_length=10, fec=True,
                                  max_empty_frames=0)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10, fec=True)
    fec = fec_chain.build_fec(txcfg, H)
    F = 4
    tx = session.StreamTx(txcfg, frames_per_block=F, fec=fec, seed=9)
    cap = tx._capacity()
    assert cap == int(fec["user_bytes_tab"][1])  # BPSK default
    rng = np.random.RandomState(8)
    pdus = [rng.randint(0, 256, rng.randint(4, cap + 1)).astype(np.uint8).tobytes()
            for _ in range(5)]
    for p in pdus:
        tx.send(p)
    rx = session.StreamRx(rxcfg, frames_per_block=F, fec=fec)
    blocks, sent = [], []
    while True:
        blk = tx.next_block()
        if blk is None:
            break
        samples, info = blk
        blocks.append(samples)
        for f in range(F):
            if info["payload_len"][f]:
                sent.append(info["payload_len"][f])
    blocks.append(np.zeros(rx.block_samples, np.complex64))
    stream = np.concatenate(blocks)
    sig = float(np.mean(np.abs(blocks[0]) ** 2))
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(4), jnp.asarray(stream), float(np.sqrt(sig / 1e3))))
    got = []
    for b in range(len(blocks)):
        outb, valid = rx.process(stream[b * rx.block_samples:(b + 1) * rx.block_samples])
        ok = np.asarray(outb.crc_ok) & valid
        for i in range(F):
            if ok[i] and np.asarray(outb.payload_len)[i]:
                got.append(bytes(np.asarray(outb.payload)[i][: np.asarray(outb.payload_len)[i]]))
    assert b"".join(got) == b"".join(pdus)


def test_stream_rx_sample_slip_resync():
    """A mid-stream sample slip (dropped samples, e.g. an overrun) must
    not kill the session: the per-block phase vote re-locks and frames
    decode again; the lost-frame counter reflects the outage."""
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    F = 4
    n_blocks = 8
    B = F * n_blocks
    rng = np.random.RandomState(1)
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
    # drop 137 samples mid-stream (between frames 15 and 16ish)
    cut = 16 * cfg.frame_samples + 200
    slipped = np.concatenate([samples[:cut], samples[cut + 137:]])
    rx = session.StreamRx(cfg, frames_per_block=F)
    S = rx.block_samples
    stream = np.concatenate([slipped, np.zeros(2 * S, np.complex64)])
    stream = stream[: (len(stream) // S) * S]
    sig = float(np.mean(np.abs(samples) ** 2))
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(3), jnp.asarray(stream), float(np.sqrt(sig / 1e3))))

    decoded = set()
    for b in range(len(stream) // S):
        outb, valid = rx.process(stream[b * S:(b + 1) * S])
        ok = np.asarray(outb.crc_ok) & valid
        for i in range(F):
            if ok[i]:
                fno = int(np.asarray(outb.frame_no)[i])
                pay = np.asarray(outb.payload)[i, : plen[0]]
                assert pay.tobytes() == payload[fno, : plen[fno]].tobytes()
                decoded.add(fno)
    # everything before the slip decodes; the receiver re-locks after it
    assert all(f in decoded for f in range(15))
    assert any(f in decoded for f in range(20, B)), "never re-locked"
    assert rx.n_lost >= 1  # the outage shows up in lost-frame accounting
    assert rx.lost_frame_rate > 0


@pytest.mark.slow
def test_stream_duplex_adaptation():
    """Host-level always-on duplex: the high-SNR direction upgrades its
    TX constellation via the in-band echo; the low-SNR one stays BPSK."""
    txcfg = cfgmod.make_tx_config(None, frame_length=10, max_empty_frames=-1)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10)

    def make_chan(snr_db, seed):
        k = [jax.random.PRNGKey(seed)]

        def chan(samples):
            k[0], sub = jax.random.split(k[0])
            sig = float(np.mean(np.abs(samples) ** 2))
            return channel.awgn(sub, jnp.asarray(samples),
                                float(np.sqrt(sig / 10 ** (snr_db / 10))))

        return chan

    dpx = session.StreamDuplex(
        txcfg, rxcfg, txcfg, rxcfg,
        make_chan(30.0, 11), make_chan(5.0, 12), frames_per_block=8)
    for _ in range(4):
        res = dpx.step()
        assert res is not None
    # A->B at 30 dB: B's decision ladder climbs, echo switches A's TX up
    assert dpx.tx_a.constellation > int(cn.ConstellationType.BPSK)
    # B->A at 5 dB: A keeps requesting BPSK
    assert dpx.tx_b.constellation == int(cn.ConstellationType.BPSK)


@pytest.mark.slow
def test_stream_rx_pipelined_matches_plain():
    """StreamRxPipelined(depth=3) output is bit-identical to StreamRx,
    shifted by depth-1 blocks (only the HOST readback is deferred; the
    device-side state chain is the same)."""
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    F = 4
    n_blocks = 6
    B = F * n_blocks
    rng = np.random.RandomState(7)
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
        jax.random.PRNGKey(0),
    )
    rx = session.StreamRx(cfg, frames_per_block=F)
    S = rx.block_samples
    stream = np.concatenate([
        np.zeros(137, np.complex64),
        np.asarray(out.samples).reshape(-1),
        np.zeros((n_blocks + 1) * S, np.complex64),
    ])[: (n_blocks + 1) * S]
    sig = float(np.mean(np.abs(np.asarray(out.samples)) ** 2))
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(1), jnp.asarray(stream),
        float(np.sqrt(sig / 10**3))))

    prx = session.StreamRxPipelined(cfg, frames_per_block=F, depth=3)
    plain, piped = [], []
    for b in range(n_blocks + 1):
        chunk = stream[b * S : (b + 1) * S]
        plain.append(rx.process(chunk))
        r = prx.process(chunk)
        if r is not None:
            piped.append(r)
    piped.extend(prx.drain())

    assert len(piped) == len(plain)
    n_ok = 0
    for (o_a, v_a), (o_b, v_b) in zip(plain, piped):
        np.testing.assert_array_equal(v_a, v_b)
        # the block-tied masks (BlockMasks) must match the device truth
        # PER BLOCK even through drain(), where every readback runs
        # before any consumer sees a result (regression: session-level
        # last_* held only the final drained block's masks)
        np.testing.assert_array_equal(v_b.header_ok,
                                      np.asarray(o_b.header_ok))
        np.testing.assert_array_equal(v_b.crc_ok, np.asarray(o_b.crc_ok))
        np.testing.assert_array_equal(v_a.header_ok, v_b.header_ok)
        np.testing.assert_array_equal(np.asarray(o_a.crc_ok),
                                      np.asarray(o_b.crc_ok))
        np.testing.assert_array_equal(np.asarray(o_a.frame_no),
                                      np.asarray(o_b.frame_no))
        np.testing.assert_array_equal(np.asarray(o_a.payload),
                                      np.asarray(o_b.payload))
        n_ok += int((np.asarray(o_a.crc_ok) & v_a).sum())
    assert n_ok == B
    assert rx.n_frames == prx.n_frames and rx.n_lost == prx.n_lost


def test_stream_rx_monitor_probe():
    """A probe-equipped StreamRx publishes one parseable MonitorEqMsg
    per received frame, continuously across blocks (ref always-on
    monitor attachment, frame_equalizer_vcvc_impl.cc:210-216)."""
    from gr_dtl_jax.testbed import monitor

    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    F = 4
    n_blocks = 3
    B = F * n_blocks
    rng = np.random.RandomState(3)
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
        jax.random.PRNGKey(0),
    )
    probe = monitor.MonitorProbe(address=None)  # capture mode
    rx = session.StreamRx(cfg, frames_per_block=F, probe=probe)
    S = rx.block_samples
    stream = np.asarray(out.samples).reshape(-1)
    stream = np.pad(stream, (0, n_blocks * S - len(stream) % (n_blocks * S)))
    sig = float(np.mean(np.abs(np.asarray(out.samples)) ** 2))
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(1), jnp.asarray(stream),
        float(np.sqrt(sig / 10**3))))
    n_rx = 0
    for b in range(len(stream) // S):
        outb, valid = rx.process(stream[b * S : (b + 1) * S])
        n_rx += int((np.asarray(outb.header_ok) & valid).sum())
    assert n_rx == B
    assert len(probe.captured) == B
    parser = monitor.MonitorParser()
    seen_counters = []
    for blob in probe.captured:
        d = parser.parse(blob)
        assert d["proto_id"] == monitor.EQ_MSG
        assert d["constellation_key"] in (1, 2, 3, 4)
        assert -10.0 < d["estimated_snr_tag_key"] < 60.0
        seen_counters.append(d["sent_counter"])
    assert seen_counters == list(range(1, B + 1))


def test_stream_tx_pacing():
    """pace=True holds next_block to the wall-clock rate of
    cfg.sample_rate (ref ofdm_adaptive_frame_bb_impl.cc sleep_until
    pacing): emitting N blocks takes at least (N-1) block durations,
    and unpaced emission is measurably faster."""
    import time

    txcfg = cfgmod.make_tx_config(
        {"sample_rate": 200_000}, frame_length=6)
    tx = session.StreamTx(txcfg, frames_per_block=2, pace=True)
    rng = np.random.RandomState(0)
    for _ in range(16):
        tx.send(rng.randint(0, 256, 24).astype(np.uint8).tobytes())
    blk_dt = tx.block_samples / 200_000
    tx.next_block()  # first block sets the clock (compile excluded)
    t0 = time.monotonic()
    for _ in range(4):
        assert tx.next_block() is not None
    paced = time.monotonic() - t0
    assert paced >= 4 * blk_dt * 0.85, (paced, blk_dt)

    tx2 = session.StreamTx(txcfg, frames_per_block=2, pace=False)
    for _ in range(16):
        tx2.send(rng.randint(0, 256, 24).astype(np.uint8).tobytes())
    tx2.next_block()
    t0 = time.monotonic()
    for _ in range(4):
        assert tx2.next_block() is not None
    unpaced = time.monotonic() - t0
    assert unpaced < paced


@pytest.mark.slow
def test_stream_simplex_soak_fading_sfo():
    """Soak: an always-on simplex session survives 30 steps of Rayleigh
    selective fading + ±20 ppm clock drift + AWGN on the forward link
    and a lossy reverse link — adaptation keeps converging, counters
    stay consistent, nothing wedges (the deployment robustness case the
    reference's always-on flowgraphs live in)."""
    txcfg = cfgmod.make_tx_config(None, frame_length=6)
    rxcfg = cfgmod.make_rx_config(None, frame_length=6)
    keys = iter(jax.random.split(jax.random.PRNGKey(42), 400))

    def chan_fwd(s):
        s = jnp.asarray(s)
        s = channel.selective_fading(next(keys), s, doppler_norm=3e-5)
        s = channel.sample_clock_offset(s, 20.0)
        sig = jnp.sqrt(jnp.mean(jnp.abs(s) ** 2) + 1e-12)
        return channel.awgn(next(keys), s, 0.05 * sig)

    drop = iter(np.random.RandomState(3).rand(400))

    def chan_rev(s):
        # bursty reverse loss: 30% of blocks are silence
        if next(drop) < 0.3:
            return np.zeros_like(np.asarray(s))
        return channel.awgn(next(keys), jnp.asarray(s), 0.05)

    sx = session.StreamSimplex(txcfg, rxcfg, chan_fwd, chan_rev,
                               frames_per_block=4, seed=1)
    rng = np.random.RandomState(1)
    for _ in range(150):
        sx.tx.send(rng.randint(0, 256, 32).astype(np.uint8).tobytes())

    steps = 0
    n_applied = 0
    decoded_steps = 0
    for _ in range(30):
        r = sx.step()
        if r is None:
            break
        steps += 1
        if r["applied"] is not None:
            n_applied += 1
        if r["ok"].any():
            decoded_steps += 1
    assert steps == 30
    # the impaired link still carries frames most of the time and the
    # feedback loop still closes through the lossy reverse channel
    assert decoded_steps >= 20, decoded_steps
    assert n_applied >= 5, n_applied
    assert sx.rx.n_frames > 0
    assert 0.0 <= sx.rx.lost_frame_rate < 0.5


def _frame_stream(txcfg, B, offset, n_blocks, block_samples, seed=0,
                  noise_db=30.0):
    """B frames of mixed MCS starting at `offset`, padded to whole blocks."""
    txp = transmitter.build_tx(txcfg)
    rng = np.random.RandomState(seed)
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
        jax.random.PRNGKey(seed))
    sig = float(np.mean(np.abs(np.asarray(out.samples)) ** 2))
    stream = np.concatenate([
        np.zeros(offset, np.complex64),
        np.asarray(out.samples).reshape(-1),
        np.zeros(n_blocks * block_samples, np.complex64),
    ])[: n_blocks * block_samples]
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(seed + 50), jnp.asarray(stream),
        float(np.sqrt(sig / 10 ** (noise_db / 10)))))
    return stream, payload, plen


def test_stream_rx_mega_matches_stream_rx():
    """K blocks per dispatch (in-graph scan over carried state) must be
    bit-identical to K successive StreamRx calls."""
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    F, K, n_disp = 4, 3, 2
    ref = session.StreamRx(cfg, frames_per_block=F)
    mega = session.StreamRxMega(cfg, frames_per_block=F,
                                blocks_per_dispatch=K)
    blk = ref.block_samples
    n_blocks = K * n_disp
    B = (n_blocks - 1) * F  # idle air at the end
    stream, payload, plen = _frame_stream(txcfg, B, 300, n_blocks, blk)

    ref_out = []
    for b in range(n_blocks):
        o, v = ref.process(stream[b * blk: (b + 1) * blk])
        ref_out.append((o, np.asarray(v), v.header_ok.copy(),
                        v.crc_ok.copy()))
    decoded = {}
    for d in range(n_disp):
        o, v = mega.process(stream[d * K * blk: (d + 1) * K * blk])
        # masks equal the concatenation of the per-block StreamRx masks
        rv = np.concatenate([r[1] for r in ref_out[d * K: (d + 1) * K]])
        rh = np.concatenate([r[2] for r in ref_out[d * K: (d + 1) * K]])
        rc = np.concatenate([r[3] for r in ref_out[d * K: (d + 1) * K]])
        np.testing.assert_array_equal(np.asarray(v), rv)
        np.testing.assert_array_equal(mega.last_header_ok, rh)
        np.testing.assert_array_equal(mega.last_crc_ok, rc)
        pays = np.asarray(o.payload)
        nos = np.asarray(o.frame_no)
        lens = np.asarray(o.payload_len)
        ref_pay = np.concatenate(
            [np.asarray(r[0].payload) for r in ref_out[d * K: (d + 1) * K]])
        ok = rv & rc
        np.testing.assert_array_equal(pays[ok], ref_pay[ok])
        for i in np.nonzero(ok)[0]:
            decoded[int(nos[i])] = pays[i, : lens[i]].tobytes()
    assert mega.n_lost == ref.n_lost and mega.n_frames == ref.n_frames
    assert len(decoded) == B
    for i in range(B):
        assert decoded[i] == payload[i, : plen[i]].tobytes()


def test_stream_rx_prefetch_ingest_identical():
    """Double-buffered ingest (prefetch handles) decodes identically to
    plain numpy feeding."""
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    F, n_blocks = 4, 4
    B = (n_blocks - 1) * F
    rx_a = session.StreamRx(cfg, frames_per_block=F)
    rx_b = session.StreamRx(cfg, frames_per_block=F)
    blk = rx_a.block_samples
    stream, payload, plen = _frame_stream(txcfg, B, 211, n_blocks, blk,
                                          seed=3)
    chunks = [stream[b * blk: (b + 1) * blk] for b in range(n_blocks)]
    # plain path
    plain = [rx_a.process(c) for c in chunks]
    # prefetched path: block k+1's H2D is issued before block k's readback
    pref = []
    handle = rx_b.prefetch(chunks[0])
    for b in range(n_blocks):
        nxt = rx_b.prefetch(chunks[b + 1]) if b + 1 < n_blocks else None
        pref.append(rx_b.process(handle))
        handle = nxt
    for (oa, va), (ob, vb) in zip(plain, pref):
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        np.testing.assert_array_equal(va.crc_ok, vb.crc_ok)
        np.testing.assert_array_equal(np.asarray(oa.payload),
                                      np.asarray(ob.payload))
    assert rx_a.n_lost == rx_b.n_lost and rx_a.n_frames == rx_b.n_frames


def test_stream_rx_mega_coded_tb_matches_stream_rx():
    """Megastep with W=2 transport blocks: the TB ring chained through
    the in-graph scan must emit the same TBs as K successive StreamRx
    calls (loss re-anchoring included)."""
    import os

    from gr_dtl_jax.utils import alist as alist_mod
    from gr_dtl_jax.models import fec_chain

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    H = alist_mod.load_alist(os.path.join(here, "examples",
                                          "n_0100_k_0027.alist"))
    W = 2
    txcfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10, fec=True)
    fec = fec_chain.build_fec(txcfg, H, tb_frames=W)
    txp = transmitter.build_tx(txcfg, fec)
    F, K, n_disp = 4, 2, 2
    ref = session.StreamRx(rxcfg, frames_per_block=F, fec=fec)
    mega = session.StreamRxMega(rxcfg, frames_per_block=F,
                                blocks_per_dispatch=K, fec=fec)
    blk = ref.block_samples
    n_blocks = K * n_disp
    G = (n_blocks - 1) * F // W  # TBs (idle air at the end)
    B = G * W
    rng = np.random.RandomState(17)
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    plen = np.zeros(B, np.int32)
    cnst = np.full(B, 2, np.int32)
    nb = int(fec["user_bytes_tab"][2])
    for g in range(G):
        plen[g * W] = nb
        payload[g * W, :nb] = rng.randint(0, 256, nb)
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
        jax.random.PRNGKey(3))
    samples = np.asarray(out.samples).copy()
    sig = float(np.mean(np.abs(samples) ** 2))
    # corrupt one mid-TB frame: re-anchoring must chain through the scan
    P = rxcfg.frame_samples
    k = jax.random.PRNGKey(55)
    samples[3] = np.asarray(
        (jax.random.normal(k, (P,)) + 1j
         * jax.random.normal(jax.random.split(k)[0], (P,)))
        * np.sqrt(sig / 2)).astype(np.complex64)
    stream = np.concatenate([
        np.zeros(260, np.complex64), samples.reshape(-1),
        np.zeros(n_blocks * blk, np.complex64)])[: n_blocks * blk]
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(5), jnp.asarray(stream),
        float(np.sqrt(sig / 10 ** 3))))

    ref_tbs = []
    for b in range(n_blocks):
        _o, _v, tb = ref.process(stream[b * blk: (b + 1) * blk])
        ref_tbs.append({kk: np.asarray(vv) for kk, vv in tb.items()})
    for d in range(n_disp):
        _o, _v, tb = mega.process(stream[d * K * blk: (d + 1) * K * blk])
        tb = {kk: np.asarray(vv) for kk, vv in tb.items()}
        for kk in ("valid", "crc_ok", "tb_no", "payload_len"):
            want = np.concatenate(
                [r[kk] for r in ref_tbs[d * K: (d + 1) * K]])
            np.testing.assert_array_equal(tb[kk], want,
                                          err_msg=f"tb[{kk}] d={d}")
        want_pay = np.concatenate(
            [r["payload"] for r in ref_tbs[d * K: (d + 1) * K]])
        v = tb["valid"] & tb["crc_ok"]
        np.testing.assert_array_equal(tb["payload"][v], want_pay[v])
    # flush parity
    mf, rf = mega.flush_tb(), ref.flush_tb()
    assert bool(np.asarray(mf["valid"])[0]) == bool(np.asarray(rf["valid"])[0])
