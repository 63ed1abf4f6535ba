"""Continuous sharded streaming session (parallel/session.ShardedStreamRx):
N successive sharded blocks on a (stream, time) mesh must match the
single-device StreamRx run per stream — same valid/header/CRC masks,
same payload bytes, same frame numbers, same loss accounting — with all
carried state (tail, trigger lock, expected-frame, TB ring) chained on
device across calls.

This is the multi-device counterpart of the reference's always-on
receiver (python/dtl/ofdm_receiver.py:59-246) per SURVEY.md §7 step 5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
from gr_dtl_jax.ops import channel, constellation as cn
from gr_dtl_jax.models import fec_chain, session, transmitter
from gr_dtl_jax.parallel import mesh as meshmod
from gr_dtl_jax.parallel.session import ShardedStreamRx

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIST = os.path.join(HERE, "examples", "n_0100_k_0027.alist")


def _stream_samples(txp, txcfg, B, seed, offset, n_blocks, block_samples,
                    noise_db=30.0):
    """One stream's continuous timeline: B frames starting mid-block at
    `offset`, padded to n_blocks whole blocks, AWGN at noise_db."""
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
        jax.random.PRNGKey(seed + 100), jnp.asarray(stream),
        float(np.sqrt(sig / 10 ** (noise_db / 10)))))
    return stream, payload, plen


def test_sharded_stream_rx_matches_single_device():
    """4 successive sharded blocks, 2 streams x 4 time shards: every
    mask, payload byte, frame number, and loss count must equal the
    per-stream single-device StreamRx run."""
    assert jax.device_count() >= 8
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    m = meshmod.make_mesh(n_stream=2, n_time=4)
    S, F, n_blocks = 2, 8, 4
    B = 3 * F  # frames per stream (some trailing idle air in block 4)

    srx = ShardedStreamRx(cfg, m, n_streams=S, frames_per_block=F)
    refs = [session.StreamRx(cfg, frames_per_block=F) for _ in range(S)]
    blk = srx.block_samples
    assert blk == refs[0].block_samples

    streams, payloads, plens = [], [], []
    for s in range(S):
        st, pay, pl = _stream_samples(txp, txcfg, B, seed=s, offset=300 + 211 * s,
                                      n_blocks=n_blocks, block_samples=blk)
        streams.append(st)
        payloads.append(pay)
        plens.append(pl)
    streams = np.stack(streams)  # [S, n_blocks*blk]

    decoded = [dict() for _ in range(S)]
    for b in range(n_blocks):
        chunk = streams[:, b * blk: (b + 1) * blk]
        out, valid = srx.process(chunk)
        pay = np.asarray(out.payload)
        lens = np.asarray(out.payload_len)
        nos = np.asarray(out.frame_no)
        for s in range(S):
            ref_out, ref_valid = refs[s].process(chunk[s])
            # masks byte-identical to the single-device session
            np.testing.assert_array_equal(valid[s], np.asarray(ref_valid),
                                          err_msg=f"valid s={s} b={b}")
            np.testing.assert_array_equal(
                srx.last_header_ok[s], ref_valid.header_ok,
                err_msg=f"header_ok s={s} b={b}")
            np.testing.assert_array_equal(
                srx.last_crc_ok[s], ref_valid.crc_ok,
                err_msg=f"crc_ok s={s} b={b}")
            ok = srx.last_crc_ok[s] & valid[s]
            np.testing.assert_array_equal(nos[s][ok],
                                          np.asarray(ref_out.frame_no)[ok])
            np.testing.assert_array_equal(pay[s][ok],
                                          np.asarray(ref_out.payload)[ok])
            for i in np.nonzero(ok)[0]:
                decoded[s][int(nos[s][i])] = pay[s][i, : lens[s][i]].tobytes()

    for s in range(S):
        assert srx.n_lost[s] == refs[s].n_lost
        assert srx.n_frames[s] == refs[s].n_frames
        # and the session actually decoded the full stream
        assert len(decoded[s]) == B
        for i in range(B):
            assert decoded[s][i] == payloads[s][i, : plens[s][i]].tobytes()


@pytest.mark.slow
def test_sharded_stream_rx_coded_tb_matches_single_device():
    """Coded path (W=2 transport blocks): the sharded session's
    replicated TB-reassembly scan must emit the same TBs with the same
    payloads as the single-device session, including across a corrupted
    frame (loss re-anchoring)."""
    assert jax.device_count() >= 8
    W = 2
    txcfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10, fec=True)
    H = alist_mod.load_alist(ALIST)
    fec = fec_chain.build_fec(txcfg, H, tb_frames=W)
    txp = transmitter.build_tx(txcfg, fec)
    m = meshmod.make_mesh(n_stream=2, n_time=4)
    S, F = 2, 8
    G = 6                      # TBs per stream
    B = G * W                  # frames per stream
    n_blocks = 3

    srx = ShardedStreamRx(rxcfg, m, n_streams=S, frames_per_block=F, fec=fec)
    refs = [session.StreamRx(rxcfg, frames_per_block=F, fec=fec)
            for _ in range(S)]
    blk = srx.block_samples

    streams, tb_payloads = [], []
    nb = int(fec["user_bytes_tab"][2])
    P = rxcfg.frame_samples
    for s in range(S):
        rng = np.random.RandomState(10 + s)
        payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
        plen = np.zeros(B, np.int32)
        cnst = np.full(B, 2, np.int32)
        for g in range(G):
            plen[g * W] = nb
            payload[g * W, :nb] = rng.randint(0, 256, nb)
        out = transmitter.tx_frames(
            txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
            jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32),
            jax.random.PRNGKey(20 + s))
        samples = np.asarray(out.samples).copy()
        sig = float(np.mean(np.abs(samples) ** 2))
        if s == 1:
            # corrupt one mid-TB frame on stream 1 only: same-power noise
            k = jax.random.PRNGKey(99)
            samples[5] = np.asarray(
                (jax.random.normal(k, (P,)) + 1j
                 * jax.random.normal(jax.random.split(k)[0], (P,)))
                * np.sqrt(sig / 2)).astype(np.complex64)
        stream = np.concatenate([
            np.zeros(150 + 97 * s, np.complex64), samples.reshape(-1),
            np.zeros(n_blocks * blk, np.complex64)])[: n_blocks * blk]
        stream = np.asarray(channel.awgn(
            jax.random.PRNGKey(30 + s), jnp.asarray(stream),
            float(np.sqrt(sig / 10 ** 3))))
        streams.append(stream)
        tb_payloads.append(payload)
    streams = np.stack(streams)

    for b in range(n_blocks):
        chunk = streams[:, b * blk: (b + 1) * blk]
        out, valid, tb = srx.process(chunk)
        tb_np = {k: np.asarray(v) for k, v in tb.items()}
        for s in range(S):
            _ro, ref_valid, ref_tb = refs[s].process(chunk[s])
            np.testing.assert_array_equal(valid[s], np.asarray(ref_valid),
                                          err_msg=f"valid s={s} b={b}")
            for key in ("valid", "crc_ok", "tb_no", "payload_len"):
                np.testing.assert_array_equal(
                    tb_np[key][s], np.asarray(ref_tb[key]),
                    err_msg=f"tb[{key}] s={s} b={b}")
            v = tb_np["valid"][s] & tb_np["crc_ok"][s]
            np.testing.assert_array_equal(
                tb_np["payload"][s][v], np.asarray(ref_tb["payload"])[v],
                err_msg=f"tb payload s={s} b={b}")

    # end-of-stream flush agrees too
    fl = srx.flush_tb()
    for s in range(S):
        ref_fl = refs[s].flush_tb()
        assert bool(np.asarray(fl["valid"])[s, 0]) == bool(ref_fl["valid"][0])
        if bool(ref_fl["valid"][0]) and bool(ref_fl["crc_ok"][0]):
            assert bool(np.asarray(fl["crc_ok"])[s, 0])
            ln = int(np.asarray(fl["payload_len"])[s, 0])
            np.testing.assert_array_equal(
                np.asarray(fl["payload"])[s, 0, :ln],
                np.asarray(ref_fl["payload"])[0, :ln])


def test_sharded_megastep_matches_single_device():
    """K=2 sharded blocks per dispatch (in-graph scan over the sharded
    carried state) must equal 2K successive single-device StreamRx
    blocks per stream."""
    assert jax.device_count() >= 8
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    m = meshmod.make_mesh(n_stream=2, n_time=4)
    S, F, K, n_disp = 2, 8, 2, 2
    n_blocks = K * n_disp
    B = (n_blocks - 1) * F

    srx = ShardedStreamRx(cfg, m, n_streams=S, frames_per_block=F,
                          blocks_per_dispatch=K)
    refs = [session.StreamRx(cfg, frames_per_block=F) for _ in range(S)]
    blk = srx.block_samples
    assert srx.dispatch_samples == K * blk

    streams, payloads, plens = [], [], []
    for s in range(S):
        st, pay, pl = _stream_samples(txp, txcfg, B, seed=40 + s,
                                      offset=250 + 131 * s,
                                      n_blocks=n_blocks, block_samples=blk)
        streams.append(st)
        payloads.append(pay)
        plens.append(pl)
    streams = np.stack(streams)

    decoded = [dict() for _ in range(S)]
    for d in range(n_disp):
        chunk = streams[:, d * K * blk: (d + 1) * K * blk]
        out, valid = srx.process(chunk)          # out: [S, K, F, ...]
        pay = np.asarray(out.payload)
        lens = np.asarray(out.payload_len)
        nos = np.asarray(out.frame_no)
        for s in range(S):
            rv, rh, rc, rp, rn = [], [], [], [], []
            for k in range(K):
                ro, rva = refs[s].process(
                    chunk[s, k * blk: (k + 1) * blk])
                rv.append(np.asarray(rva))
                rh.append(rva.header_ok)
                rc.append(rva.crc_ok)
                rp.append(np.asarray(ro.payload))
                rn.append(np.asarray(ro.frame_no))
            np.testing.assert_array_equal(valid[s], np.concatenate(rv))
            np.testing.assert_array_equal(srx.last_header_ok[s],
                                          np.concatenate(rh))
            np.testing.assert_array_equal(srx.last_crc_ok[s],
                                          np.concatenate(rc))
            ok = (valid[s] & srx.last_crc_ok[s]).reshape(K, F)
            np.testing.assert_array_equal(pay[s][ok],
                                          np.stack(rp)[ok])
            np.testing.assert_array_equal(nos[s][ok],
                                          np.stack(rn)[ok])
            for k, f in zip(*np.nonzero(ok)):
                decoded[s][int(nos[s][k, f])] = (
                    pay[s][k, f, : lens[s][k, f]].tobytes())
    for s in range(S):
        assert srx.n_lost[s] == refs[s].n_lost
        assert srx.n_frames[s] == refs[s].n_frames
        assert len(decoded[s]) == B
        for i in range(B):
            assert decoded[s][i] == payloads[s][i, : plens[s][i]].tobytes()


def test_sharded_session_probe_telemetry():
    """A probe-equipped sharded session publishes one parseable
    MonitorEqMsg per received frame of every stream (the always-on
    monitor attachment, ref frame_equalizer_vcvc_impl.cc:210-216)."""
    from gr_dtl_jax.testbed import monitor

    assert jax.device_count() >= 8
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    m = meshmod.make_mesh(n_stream=2, n_time=4)
    S, F, n_blocks = 2, 8, 2
    B = F  # one block of frames per stream, second block idle

    probe = monitor.MonitorProbe(address=None)  # capture mode
    srx = ShardedStreamRx(cfg, m, n_streams=S, frames_per_block=F,
                          probe=probe)
    blk = srx.block_samples
    streams = []
    for s in range(S):
        st, _pay, _pl = _stream_samples(txp, txcfg, B, seed=70 + s,
                                        offset=200 + 101 * s,
                                        n_blocks=n_blocks, block_samples=blk)
        streams.append(st)
    streams = np.stack(streams)
    n_received = 0
    for b in range(n_blocks):
        _out, valid = srx.process(streams[:, b * blk: (b + 1) * blk])
        n_received += int((valid & srx.last_header_ok).sum())
    assert n_received >= S * B  # every transmitted frame was received
    assert len(probe.captured) == n_received
    parser = monitor.MonitorParser()
    seen_snrs = []
    for blob in probe.captured:
        msg = parser.parse(blob)
        seen_snrs.append(msg["estimated_snr_tag_key"])
    # 30 dB AWGN: SNR estimates in a sane band
    assert all(15.0 < v < 45.0 for v in seen_snrs), seen_snrs[:5]
