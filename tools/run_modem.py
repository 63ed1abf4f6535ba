#!/usr/bin/env python3
"""CLI modem runner — the app layer (the reference's grc_run + example
flowgraphs analog, SURVEY.md #45-49).

Modes:
  loopback     TX -> AWGN(+CFO) channel -> RX over a frame batch
               (ofdm_adaptive_example.grc analog), optional LDPC FEC
  full-duplex  two nodes, in-band MCS adaptation session
  simplex      OFDM forward + feedback-burst reverse session
  stream       always-on RX daemon over a c64 sample source
               (file/FIFO/TCP), optional pipelined readback, megastep
               (--blocks-per-dispatch), ZMQ telemetry and frame store
  stream-tx    always-on TX daemon: PDUs -> StreamTx -> c64 sink;
               pair with `stream` (RX listens, TX connects) for a
               two-process link:
                 run_modem.py stream --source listen:5661 ... &
                 run_modem.py stream-tx --sink tcp:127.0.0.1:5661 ...
  stream-sharded
               always-on SHARDED RX daemon: N streams over a
               (stream, time) device mesh, carried state chained on
               device (parallel/session.ShardedStreamRx); megastep via
               --blocks-per-dispatch; --selftest self-checks

Examples:
  run_modem.py loopback --config examples/config.json --frames 64 --snr-db 25
  run_modem.py loopback --config examples/config_fec.json --snr-db 8 --mcs-id 0
  run_modem.py full-duplex --rounds 48 --snr-db 30 --snr-db-reverse 22
  run_modem.py simplex --rounds 40 --snr-db 22
  ... [--store-tx tx.dat --store-rx rx.dat] [--zmq tcp://*:5550] [--json]

Writes reference-format frame stores scoreable by tools/ber.py, and
publishes equalizer telemetry over ZMQ when --zmq is given.

Runs on the GPU; --cpu (or RUN_MODEM_CPU=1) runs on the CPU with 8
virtual devices instead.  Without it, a missing GPU is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def _platform(args=None):
    """JAX on the GPU, or on the CPU when --cpu / RUN_MODEM_CPU=1 asks."""
    from gr_dtl_jax.utils.platform import select_platform

    return select_platform(getattr(args, "cpu", False), tool="run_modem")


def loopback(args):
    """TX -> channel -> RX over one frame batch.

    Returns (summary dict, (payload, payload_len) as sent, RxOut)."""
    jax = _platform(args)
    import time as _time

    import jax.numpy as jnp

    from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
    from gr_dtl_jax.ops import channel, constellation as cn
    from gr_dtl_jax.models import fec_chain, receiver, transmitter

    cfg = cfgmod.make_tx_config(args.config, frame_length=args.frame_length)
    rxcfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    fec = None
    if cfg.fec:
        fec = fec_chain.build_fec(
            cfg, [alist_mod.load_alist(path) for _, path in cfg.fec_codes])
    txp = transmitter.build_tx(cfg, fec)
    rxp = receiver.build_rx(rxcfg, fec)

    B = args.frames
    rng = np.random.RandomState(args.seed)
    if args.mcs_id is not None and not (0 <= args.mcs_id < len(cfg.mcs)):
        sys.exit(f"error: --mcs-id must be 0..{len(cfg.mcs) - 1} for this config")
    cnst_id = int(cfg.mcs[args.mcs_id][1][0]) if args.mcs_id is not None else 2
    cnst = np.full(B, cnst_id, np.int32)
    fec_ids = None
    if fec is not None:
        # the MCS entry names its code too — transmit with THAT code
        code_ids = {name: i + 1 for i, (name, _) in enumerate(cfg.fec_codes)}
        fec_name = (cfg.mcs[args.mcs_id][1][1] if args.mcs_id is not None
                    else cfg.fec_codes[0][0])
        fid = code_ids.get(fec_name, 1)
        fec_ids = np.full(B, fid, np.int32)
        maxb = fec["max_payload_bytes"]
        plen = np.full(
            B, int(fec["user_bytes_tab2"][fid, int(cn.BITS_PER_SYMBOL[cnst_id])]),
            np.int32)
    else:
        maxb = cfg.max_frame_bytes()
        plen = np.full(B, cfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst_id])) - 4,
                       np.int32)
    payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])

    # the whole loopback is one compiled TX -> channel -> RX program
    @jax.jit
    def loopback_step(payload_d, plen_d, cnst_d, fec_id_d, key_tx, key_ch):
        out = transmitter.tx_frames(
            txp, payload_d, plen_d, cnst_d,
            jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32) % 4096,
            key_tx, fec_id=fec_id_d,
        )
        sig = jnp.mean(jnp.abs(out.samples) ** 2)
        noise_v = jnp.sqrt(sig / 10 ** (args.snr_db / 10))
        stream = jnp.concatenate(
            [jnp.zeros(517, jnp.complex64), out.samples.reshape(-1),
             jnp.zeros(400, jnp.complex64)]
        )
        stream = channel.channel_model(
            key_ch, stream,
            noise_voltage=noise_v, freq_offset=args.cfo, fft_len=cfg.fft_len,
        )
        frames, eps = receiver.detect_and_extract(stream, rxcfg, B)
        return receiver.rx_frames(rxp, frames)

    tx_view = (payload, plen)  # user payload for the offline BER store
    step_args = (
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        None if fec_ids is None else jnp.asarray(fec_ids),
        jax.random.PRNGKey(args.seed), jax.random.PRNGKey(args.seed + 1),
    )
    # first call compiles; the second, identical one is the steady step
    t0 = _time.perf_counter()
    rx = jax.block_until_ready(loopback_step(*step_args))
    first_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    rx = jax.block_until_ready(loopback_step(*step_args))
    step_ms = (_time.perf_counter() - t0) * 1e3

    res = _summarize(rx, B)
    res["first_call_s"] = first_s
    res["step_ms"] = step_ms
    res["mode"] = "loopback"
    res["snr_cfg_db"] = args.snr_db
    res["cfo"] = args.cfo
    return res, tx_view, rx


def run_loopback(args):
    res, tx_view, rx = loopback(args)
    _stores_and_telemetry(args, tx_view, rx)
    _report(args, res)
    return res


def run_full_duplex(args):
    jax = _platform(args)
    from gr_dtl_jax.utils import config as cfgmod
    from gr_dtl_jax.models import full_duplex

    cfg = cfgmod.make_full_duplex_config(args.config, frame_length=args.frame_length)
    fec = None
    if cfg.fec:
        from gr_dtl_jax.utils import alist as alist_mod
        from gr_dtl_jax.models import fec_chain

        fec = fec_chain.build_fec(
            cfg, [alist_mod.load_alist(path) for _, path in cfg.fec_codes])
    # convert SNRs to noise voltages against unit-ish signal power (~0.81)
    nv = lambda snr: float(np.sqrt(0.81 / 10 ** (snr / 10)))
    run, tables = full_duplex.build_full_duplex(
        cfg, noise_ab=nv(args.snr_db), noise_ba=nv(args.snr_db_reverse), fec=fec
    )
    state = full_duplex.initial_duplex_state(cfg, tables)
    state, telem = run(state, jax.random.PRNGKey(args.seed), n_rounds=args.rounds)
    res = {
        "mode": "full-duplex",
        "rounds": args.rounds,
        "a_tx_cnst_final": int(np.asarray(telem["a_tx_cnst"])[-1]),
        "b_tx_cnst_final": int(np.asarray(telem["b_tx_cnst"])[-1]),
        "a_crc_rate": float(np.asarray(telem["a_crc_ok"]).mean()),
        "b_crc_rate": float(np.asarray(telem["b_crc_ok"]).mean()),
        "snr_at_a_db": float(np.asarray(telem["snr_at_a"])[-8:].mean()),
        "snr_at_b_db": float(np.asarray(telem["snr_at_b"])[-8:].mean()),
    }
    _report(args, res)
    return res


def run_simplex(args):
    jax = _platform(args)
    from gr_dtl_jax.utils import config as cfgmod
    from gr_dtl_jax.models import simplex

    cfg = cfgmod.make_tx_config(args.config, frame_length=args.frame_length)
    nv = lambda snr: float(np.sqrt(0.81 / 10 ** (snr / 10)))
    run, tables = simplex.build_simplex(
        cfg, noise_fwd=nv(args.snr_db), noise_rev=nv(args.snr_db_reverse)
    )
    state = simplex.initial_simplex_state(cfg, tables)
    state, telem = run(state, jax.random.PRNGKey(args.seed), n_rounds=args.rounds)
    res = {
        "mode": "simplex",
        "rounds": args.rounds,
        "tx_cnst_final": int(np.asarray(telem["tx_cnst"])[-1]),
        "crc_rate": float(np.asarray(telem["crc_ok"]).mean()),
        "burst_ok_rate": float(np.asarray(telem["burst_ok"]).mean()),
        "snr_db": float(np.asarray(telem["snr_db"])[-8:].mean()),
    }
    _report(args, res)
    return res


def run_stream(args):
    """Always-on receiver daemon: complex64 samples in (file / FIFO /
    TCP), decoded frames + telemetry out — the deployment entry point
    for the streaming session (the reference's ``ofdm_adaptive_rx``
    flowgraph running forever under grc_run, ofdm_receiver.py:59-246).

    ``--source`` spec:
      file:PATH      replay a capture (``--loop N`` to repeat it)
      fifo:PATH      read a named pipe
      tcp:HOST:PORT  connect to a sample server (e.g. tools/sample_link
                     TX, an SDR bridge, or another run_modem)
    """
    jax = _platform(args)
    import time as _time

    from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
    from gr_dtl_jax.models import fec_chain, session
    from gr_dtl_jax.testbed import sample_io

    rxcfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    fec = None
    if rxcfg.fec:
        fec = fec_chain.build_fec(
            rxcfg, [alist_mod.load_alist(p) for _, p in rxcfg.fec_codes],
            tb_frames=args.tb_frames)

    probe = None
    if args.zmq:
        from gr_dtl_jax.testbed import monitor

        probe = monitor.MonitorProbe(args.zmq)
    if args.pipeline_depth > 1 and args.blocks_per_dispatch > 1:
        sys.exit("error: --pipeline-depth and --blocks-per-dispatch "
                 "do not combine")
    if args.pipeline_depth > 1:
        rx = session.StreamRxPipelined(
            rxcfg, frames_per_block=args.frames_per_block, fec=fec,
            probe=probe, depth=args.pipeline_depth)
    elif args.blocks_per_dispatch > 1:
        rx = session.StreamRxMega(
            rxcfg, frames_per_block=args.frames_per_block,
            blocks_per_dispatch=args.blocks_per_dispatch, fec=fec,
            probe=probe)
    else:
        rx = session.StreamRx(rxcfg, frames_per_block=args.frames_per_block,
                              fec=fec, probe=probe)
    S = getattr(rx, "dispatch_samples", rx.block_samples)

    kind, _, rest = args.source.partition(":")
    endpoint = None
    if kind == "file":
        data = np.fromfile(rest, np.complex64)
        if len(data) == 0:
            sys.exit(f"error: empty capture {rest!r}")
        data = np.tile(data, max(1, args.loop))
        pad = (-len(data)) % S
        data = np.pad(data, (0, pad))

        def blocks():
            for b in range(len(data) // S):
                yield data[b * S : (b + 1) * S]

        src_close = lambda: None
    elif kind in ("fifo", "tcp", "listen"):
        if kind == "fifo":
            source = sample_io.fifo_source(rest)
        elif kind == "listen":
            server = sample_io.listen(port=int(rest))[0]
            endpoint = sample_io.accept_endpoint(server)
            source = endpoint.source
        else:
            host, _, port = rest.rpartition(":")
            endpoint = sample_io.connect(host or "127.0.0.1", int(port))
            source = endpoint.source

        def blocks():
            while True:
                chunk = source.read(S)
                if len(chunk) == 0:
                    return
                if len(chunk) < S:  # EOF: pad the final partial block
                    chunk = np.pad(chunk, (0, S - len(chunk)))
                    yield chunk
                    return
                yield chunk

        src_close = (endpoint.close if endpoint is not None
                     else source.close)
    else:
        sys.exit(f"error: unknown --source kind {kind!r} "
                 "(use file:, fifo:, tcp:host:port, or listen:port)")

    store = None
    if args.store_rx:
        from gr_dtl_jax.testbed.frame_store import FrameStore

        store = FrameStore(args.store_rx)

    n_blocks = n_hdr = n_crc = 0
    n_tb = n_tb_ok = 0

    def consume_tb(tb):
        # multi-frame transport blocks completed within a block
        # (loss-resilient reassembly; ref tb_decoder.cc:90-138)
        nonlocal n_tb, n_tb_ok
        if tb is None:
            return
        tb_valid = np.asarray(tb["valid"])
        n_tb += int(tb_valid.sum())
        n_tb_ok += int((np.asarray(tb["crc_ok"]) & tb_valid).sum())

    def consume(r):
        # count/store per result as it lands — a daemon must not hold
        # every block's device buffers until shutdown.  The per-frame
        # masks come from the session's single packed accounting fetch
        # (rx.last_*) — zero additional device round trips per block.
        nonlocal n_hdr, n_crc
        out, valid = r[0], r[1]
        # masks ride the valid array (BlockMasks) so they stay tied to
        # THIS block even when pipelined readbacks are drained in bulk
        ok = valid.header_ok & valid
        n_hdr += int(ok.sum())
        n_crc += int((valid.crc_ok & valid).sum())
        if len(r) > 2:
            consume_tb(r[2])
        if store is not None:
            store.store_batch(out, valid=valid)

    def _rss_mb() -> float:
        # current resident set (not the getrusage high-water mark): a
        # soak must see growth, not just the peak
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE") / 1e6

    block_s = []
    t0 = _time.monotonic()
    try:
        for chunk in blocks():
            t_blk = _time.perf_counter()
            r = rx.process(chunk)
            block_s.append(_time.perf_counter() - t_blk)
            n_blocks += 1
            if r is not None:
                consume(r)
            if args.stats_every and n_blocks % args.stats_every == 0:
                # long-run soak telemetry: one JSONL line per interval
                # (the "runs forever" evidence stream; consumed by
                # tools/soak_link.py)
                print(json.dumps({
                    "stat": "stream",
                    "t_s": round(_time.monotonic() - t0, 3),
                    "blocks": n_blocks,
                    "samples": n_blocks * S,
                    "frames_header_ok": n_hdr,
                    "frames_crc_ok": n_crc,
                    "lost_frame_rate": round(rx.lost_frame_rate, 6),
                    "rss_mb": round(_rss_mb(), 1),
                }), flush=True)
            if args.max_blocks and n_blocks >= args.max_blocks:
                break
        if args.pipeline_depth > 1:
            for r in rx.drain():
                consume(r)
        consume_tb(rx.flush_tb())  # end-of-stream TB tail (ref tb flush)
    finally:
        elapsed = _time.monotonic() - t0
        src_close()
        if store is not None:
            store.close()
        if probe is not None:
            probe.close()
    res = {
        "mode": "stream",
        "platform": jax.devices()[0].platform,
        "blocks": n_blocks,
        "samples": n_blocks * S,
        "frames_header_ok": n_hdr,
        "frames_crc_ok": n_crc,
        "lost_frames": int(rx.n_lost),
        "lost_frame_rate": rx.lost_frame_rate,
        "msamples_per_s": n_blocks * S / elapsed / 1e6,
        # the first dispatch includes compilation
        "first_block_s": block_s[0] if block_s else None,
        "block_ms_median": (float(np.median(block_s[1:])) * 1e3
                            if len(block_s) > 1 else None),
        "pipeline_depth": args.pipeline_depth,
        "blocks_per_dispatch": args.blocks_per_dispatch,
    }
    if args.tb_frames > 1:
        res["tb_emitted"] = n_tb
        res["tb_crc_ok"] = n_tb_ok
    _report(args, res)
    return res


def selftest_streams(args, dispatch_samples: int):
    """Multi-stream test input for ``stream-sharded``: ``args.streams``
    streams of random mixed-MCS frames at ``args.snr_db``, each starting
    at its own offset, spanning ``max(2, --max-blocks)`` dispatch chunks.

    Returns (samples [S, n_chunks * dispatch_samples] complex64,
    [(payload [B, max_bytes], payload_len [B])] per stream).
    """
    import jax
    import jax.numpy as jnp

    from gr_dtl_jax.models import transmitter
    from gr_dtl_jax.ops import constellation as cn
    from gr_dtl_jax.utils import config as cfgmod

    S, D = args.streams, dispatch_samples
    n_chunks = max(2, args.max_blocks or 3)
    B = (n_chunks * args.blocks_per_dispatch - 1) * args.frames_per_block
    rng = np.random.RandomState(args.seed)
    payloads = []
    txcfg = cfgmod.make_tx_config(args.config, frame_length=args.frame_length)
    txp = transmitter.build_tx(txcfg)
    tx = jax.jit(lambda pay, plen, cnst, key: transmitter.tx_frames(
        txp, pay, plen, cnst, jnp.zeros(B, jnp.int32),
        jnp.arange(B, dtype=jnp.int32), key).samples)
    chunks = np.zeros((S, n_chunks * D), np.complex64)
    maxb = txcfg.max_frame_bytes()
    for s in range(S):
        cnst = rng.randint(1, 5, B).astype(np.int32)
        pay = np.zeros((B, maxb), np.uint8)
        plen = np.zeros(B, np.int32)
        for i in range(B):
            plen[i] = txcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst[i]])) - 4
            pay[i, : plen[i]] = rng.randint(0, 256, plen[i])
        flat = np.asarray(tx(pay, plen, cnst,
                             jax.random.PRNGKey(s))).reshape(-1)
        sig = float(np.mean(np.abs(flat) ** 2))
        off = 150 + 89 * s
        chunks[s, off: off + flat.size] = flat
        nv = float(np.sqrt(sig / 10 ** (args.snr_db / 10)))
        noise = rng.randn(2, chunks.shape[1]) * (nv / np.sqrt(2))
        chunks[s] += (noise[0] + 1j * noise[1]).astype(np.complex64)
        payloads.append((pay, plen))
    return chunks, payloads


def stream_sharded(args):
    """Always-on SHARDED receiver daemon: N independent streams over a
    (stream, time) device mesh with all carried state chained on device
    (parallel/session.ShardedStreamRx) — the multi-device deployment
    entry point (SURVEY §7 step 5).

    Input layout (``--source file:PATH``): successive dispatch chunks,
    each ``streams * dispatch_samples`` complex64 stored stream-major
    ([S, dispatch_samples] row-major per chunk).  ``--selftest``
    generates its own multi-stream input and checks every frame decodes.

    Returns (summary dict, per-stream {frame_no: payload bytes} of the
    CRC-passing frames, the selftest's [(payload, payload_len)] or None).
    """
    _platform(args)
    import time as _time

    from gr_dtl_jax.utils import config as cfgmod
    from gr_dtl_jax.parallel import mesh as meshmod
    from gr_dtl_jax.parallel.session import ShardedStreamRx

    rxcfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    fec = None
    if rxcfg.fec:
        from gr_dtl_jax.utils import alist as alist_mod
        from gr_dtl_jax.models import fec_chain

        if args.tb_frames > 1:
            sys.exit("error: stream-sharded consumes in-graph-decoded "
                     "frames; W>1 transport blocks (--tb-frames) are "
                     "not wired into this mode's store loop yet")
        fec = fec_chain.build_fec(
            rxcfg, [alist_mod.load_alist(p) for _, p in rxcfg.fec_codes])
    mesh = meshmod.make_mesh(n_stream=args.mesh_stream, n_time=args.mesh_time)
    probe = None
    if args.zmq:
        from gr_dtl_jax.testbed import monitor

        probe = monitor.MonitorProbe(args.zmq)
    srx = ShardedStreamRx(rxcfg, mesh, n_streams=args.streams,
                          frames_per_block=args.frames_per_block,
                          blocks_per_dispatch=args.blocks_per_dispatch,
                          fec=fec, probe=probe)
    S, D = args.streams, srx.dispatch_samples
    chunk_len = S * D

    src_path = None
    payloads = None
    if args.selftest:
        import tempfile

        chunks, payloads = selftest_streams(args, D)
        n_chunks = chunks.shape[1] // D
        tmp = tempfile.NamedTemporaryFile(suffix=".c64", delete=False)
        # stream-major per dispatch chunk
        for c in range(n_chunks):
            chunks[:, c * D: (c + 1) * D].tofile(tmp)
        tmp.close()
        src_path = tmp.name
    else:
        if not args.source or not args.source.startswith("file:"):
            sys.exit("error: stream-sharded requires --source file:PATH "
                     "(or --selftest)")
        src_path = args.source[len("file:"):]

    data = np.fromfile(src_path, np.complex64)
    n_chunks = len(data) // chunk_len
    if n_chunks == 0:
        sys.exit(f"error: {src_path!r} holds less than one "
                 f"[{S}, {D}] dispatch chunk")

    decoded = [dict() for _ in range(S)]
    n_hdr = n_crc = 0
    chunk_s = []
    for c in range(n_chunks):
        chunk = data[c * chunk_len: (c + 1) * chunk_len].reshape(S, D)
        t0 = _time.perf_counter()
        out, valid = srx.process(chunk)[:2]
        chunk_s.append(_time.perf_counter() - t0)
        n_hdr += int(srx.last_header_ok.sum())
        n_crc += int((valid & srx.last_crc_ok).sum())
        pays = np.asarray(out.payload).reshape(S, -1, out.payload.shape[-1])
        lens = np.asarray(out.payload_len).reshape(S, -1)
        nos = np.asarray(out.frame_no).reshape(S, -1)
        ok = (valid & srx.last_crc_ok)
        for s in range(S):
            for i in np.nonzero(ok[s])[0]:
                decoded[s][int(nos[s][i])] = (
                    pays[s][i, : lens[s][i]].tobytes())
    res = {
        "mode": "stream-sharded",
        "streams": S,
        "mesh": {"stream": int(mesh.shape["stream"]),
                 "time": int(mesh.shape["time"])},
        "blocks_per_dispatch": args.blocks_per_dispatch,
        "dispatch_chunks": n_chunks,
        "frames_header_ok": n_hdr,
        "frames_crc_ok": n_crc,
        "lost_frames": int(srx.n_lost.sum()),
        # the first dispatch includes compilation
        "first_chunk_s": chunk_s[0],
        "chunk_ms_median": (float(np.median(chunk_s[1:])) * 1e3
                            if len(chunk_s) > 1 else None),
        # where the carried per-stream state lives: [device, first
        # stream, end stream] per shard
        "shards": [[str(sh.device), sh.index[0].start or 0,
                    sh.index[0].stop or S]
                   for sh in srx._tail.addressable_shards],
    }
    if args.selftest:
        ok_all = True
        for s in range(S):
            pay, plen = payloads[s]
            for i in range(pay.shape[0]):
                if decoded[s].get(i) != pay[i, : plen[i]].tobytes():
                    ok_all = False
        res["selftest_pass"] = ok_all
        os.unlink(src_path)
    return res, decoded, payloads


def run_stream_sharded(args):
    res = stream_sharded(args)[0]
    _report(args, res)
    if res.get("selftest_pass") is False:
        sys.exit("stream-sharded selftest FAILED")
    return res


def run_stream_tx(args):
    """Always-on transmitter daemon: PDUs -> StreamTx -> c64 sample
    sink (file/FIFO/TCP) — the TX half of a two-process `stream` link
    (the reference's ofdm_adaptive_tx flowgraph under grc_run).

    PDUs are random (--pdus/--pdu-bytes/--seed) — the CLI stand-in for
    a network tap; wire a tun device with tools/tun_bridge.py for real
    traffic.  ``--pace`` holds emission to cfg.sample_rate wall-clock.
    """
    jax = _platform(args)
    import time as _time

    from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
    from gr_dtl_jax.models import fec_chain, session
    from gr_dtl_jax.testbed import sample_io

    txcfg = cfgmod.make_tx_config(args.config, frame_length=args.frame_length)
    fec = None
    if txcfg.fec:
        fec = fec_chain.build_fec(
            txcfg, [alist_mod.load_alist(p) for _, p in txcfg.fec_codes],
            tb_frames=args.tb_frames)
    tx = session.StreamTx(txcfg, frames_per_block=args.frames_per_block,
                          fec=fec, pace=args.pace, seed=args.seed)

    kind, _, rest = args.sink.partition(":")
    endpoint = None
    if kind == "file":
        fd = os.open(rest, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        sink = sample_io.SampleSink(fd)
        closer = sink.close
    elif kind == "fifo":
        sink = sample_io.fifo_sink(rest)
        closer = sink.close
    elif kind == "tcp":
        host, _, port = rest.rpartition(":")
        endpoint = sample_io.connect(host or "127.0.0.1", int(port))
        sink = endpoint.sink
        closer = endpoint.close
    else:
        sys.exit(f"error: unknown --sink kind {kind!r} "
                 "(use file:, fifo:, or tcp:host:port)")

    rng = np.random.RandomState(args.seed)
    cap = tx._capacity()
    nbytes = min(args.pdu_bytes, cap)
    for _ in range(args.pdus):
        tx.send(rng.randint(0, 256, nbytes).astype(np.uint8).tobytes())

    store = None
    if args.store_tx:
        from gr_dtl_jax.testbed.frame_store import FrameStore

        store = FrameStore(args.store_tx)
    n_blocks = n_frames = 0
    t0 = _time.monotonic()
    try:
        while True:
            blk = tx.next_block()
            if blk is None:
                break
            samples, info = blk
            sink.write(samples)
            n_blocks += 1
            data = info["payload_len"] > 0
            n_frames += int(data.sum())
            if store is not None:
                # the data frames sent, in the RX store's format
                for i in np.nonzero(data)[0]:
                    store.store(info["payload"][i, :info["payload_len"][i]]
                                .tobytes(), int(info["frame_no"][i]))
            if args.max_blocks and n_blocks >= args.max_blocks:
                break
    finally:
        elapsed = _time.monotonic() - t0
        closer()
        if store is not None:
            store.close()
    return _report(args, {
        "mode": "stream-tx",
        "blocks": n_blocks,
        "samples": n_blocks * tx.block_samples,
        "payload_frames": n_frames,
        "pdus": args.pdus,
        "msamples_per_s": n_blocks * tx.block_samples / elapsed / 1e6,
    })


def _summarize(rx, B):
    from gr_dtl_jax.ops import metrics

    n_lost, n_total, lost_rate = metrics.lost_frames(rx.frame_no, rx.header_ok)
    return {
        "frames": B,
        "header_ok_rate": float(np.asarray(rx.header_ok).mean()),
        "crc_ok_rate": float(np.asarray(rx.crc_ok).mean()),
        "est_snr_db": float(np.asarray(rx.snr_db).mean()),
        "lost_frame_rate": float(lost_rate),
        "carr_offset": int(np.asarray(rx.carr_offset)[0]),
    }


def _stores_and_telemetry(args, tx_view, rx):
    if args.store_tx:
        from gr_dtl_jax.testbed.frame_store import FrameStore

        tx_payload, tx_plen = tx_view

        class TxView:
            payload = np.asarray(tx_payload)  # user payload (pre-coding)
            payload_len = np.asarray(tx_plen)
            frame_no = np.arange(len(tx_plen)) % 4096

        with FrameStore(args.store_tx) as s:
            s.store_batch(TxView())
    if args.store_rx:
        from gr_dtl_jax.testbed.frame_store import FrameStore

        with FrameStore(args.store_rx) as s:
            s.store_batch(rx)
    if args.zmq:
        import time

        from gr_dtl_jax.testbed import monitor

        probe = monitor.MonitorProbe(args.zmq)
        # one-shot publisher: give late SUB joiners time to (re)connect
        # before the burst (the reference publisher runs forever, so it
        # never needs this)
        time.sleep(0.5)
        builder = monitor.MonitorProto(monitor.EQ_MSG)
        for msg in monitor.eq_messages(rx):
            probe.send(builder.build(msg))
        time.sleep(0.2)  # let the PUB queue drain before close
        probe.close()


def _report(args, res):
    if args.json:
        print(json.dumps(res))
    else:
        for k, v in res.items():
            print(f"{k}: {v}")
    return res


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["loopback", "full-duplex", "simplex",
                                    "stream", "stream-tx",
                                    "stream-sharded"])
    p.add_argument("--sink", default=None,
                   help="stream-tx mode: file:PATH | fifo:PATH | "
                        "tcp:HOST:PORT sample output")
    p.add_argument("--pdus", type=int, default=64)
    p.add_argument("--pdu-bytes", type=int, default=40)
    p.add_argument("--pace", action="store_true",
                   help="stream-tx: hold emission to cfg.sample_rate")
    p.add_argument("--source", default=None,
                   help="stream mode: file:PATH | fifo:PATH | "
                        "tcp:HOST:PORT sample input")
    p.add_argument("--loop", type=int, default=1,
                   help="stream mode: replay a file: source N times")
    p.add_argument("--frames-per-block", type=int, default=16)
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="stream mode: >1 overlaps readback with compute "
                        "(StreamRxPipelined)")
    p.add_argument("--stats-every", type=int, default=0,
                   help="stream mode: emit a JSONL stats line every N "
                        "blocks (soak telemetry: counters + RSS)")
    p.add_argument("--max-blocks", type=int, default=0,
                   help="stream mode: stop after N blocks (0 = until EOF)")
    p.add_argument("--streams", type=int, default=4,
                   help="stream-sharded: independent streams")
    p.add_argument("--mesh-stream", type=int, default=None,
                   help="stream-sharded: devices on the stream axis")
    p.add_argument("--mesh-time", type=int, default=1,
                   help="stream-sharded: devices on the time axis")
    p.add_argument("--blocks-per-dispatch", type=int, default=1,
                   help="stream, stream-sharded: K blocks per dispatch "
                        "(megastep)")
    p.add_argument("--selftest", action="store_true",
                   help="stream-sharded: generate own input, assert decode")
    p.add_argument("--tb-frames", type=int, default=1,
                   help="stream mode: frames per transport block (FEC "
                        "configs; >1 enables streaming TB reassembly)")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--rounds", type=int, default=32)
    p.add_argument("--frame-length", type=int, default=20)
    p.add_argument("--snr-db", type=float, default=30.0)
    p.add_argument("--snr-db-reverse", type=float, default=25.0)
    p.add_argument("--cfo", type=float, default=0.0,
                   help="carrier offset in subcarrier units")
    p.add_argument("--mcs-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--store-tx", default=None,
                   help="loopback, stream-tx: frame store of the payloads "
                        "sent")
    p.add_argument("--store-rx", default=None)
    p.add_argument("--zmq", default=None)
    p.add_argument("--json", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (8 virtual devices); by default "
                        "the run needs a GPU")
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="config override, e.g. --set cp_len=32 "
                        "--set 'mcs=[[0,[\"bpsk\",\"no_fec\"]]]' "
                        "(the grc_run jq-override analogue)")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.set:
        overrides = {}
        for kv in args.set:
            key, _, val = kv.partition("=")
            if not _:
                sys.exit(f"error: --set needs KEY=JSON, got {kv!r}")
            try:
                overrides[key] = json.loads(val)
            except json.JSONDecodeError:
                overrides[key] = val  # bare string value
        base = {}
        if args.config:
            with open(args.config) as f:
                base = json.load(f)
        base.update(overrides)
        args.config = base  # make_*_config accepts a dict
    if args.mode == "stream" and not args.source:
        sys.exit("error: stream mode requires --source")
    if (args.mode == "stream-sharded" and not args.selftest
            and not args.source):
        sys.exit("error: stream-sharded requires --source or --selftest")
    if args.mode == "stream-tx" and not args.sink:
        sys.exit("error: stream-tx mode requires --sink")
    return args


def main(argv=None):
    """Run one mode; returns its summary dict."""
    args = parse_args(argv)
    return {"loopback": run_loopback, "full-duplex": run_full_duplex,
            "simplex": run_simplex, "stream": run_stream,
            "stream-tx": run_stream_tx,
            "stream-sharded": run_stream_sharded}[args.mode](args)


if __name__ == "__main__":
    main()
