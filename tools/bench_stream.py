#!/usr/bin/env python3
"""Benchmark: sustained streaming-session throughput on the GPU.

``bench.py`` measures the batched receiver (one jitted graph over a
frame batch).  This tool measures the deployment shape that replaces
the reference's always-on scheduler — ``session.StreamRx`` fed block by
block from the host, with everything the batch bench does NOT pay for:

  - the per-block host->device transfer of raw samples,
  - the carried tail / trigger-lock / fallback / frame-number state
    threaded through every call,
  - the host loop itself (queue bookkeeping).

Row kinds:

``accumulate``: the timed region does no device->host reads.  Every
  block's CRC / header / validity / lost counters are folded into a tiny
  on-device accumulator; one final [5]-int read both validates every
  frame of every timed block and closes the value chain (each block
  consumes the previous block's carried lock state and the accumulator
  sums every block's outputs).

``readback``: the deployment loop — every block's accounting scalars
  are read before the next block is fed (depth=1) or pipelined behind
  it (depth=2, ``StreamRxPipelined``).

``mega-host``: K blocks per dispatch (``StreamRxMega``), host-fed.

The full-duplex host session (StreamDuplex: two TX + channel + two RX
per step) is measured in both readback orderings — serialized (each
direction's read before the other's dispatch) vs pipelined (both
directions in flight before either read).

Needs a GPU unless --cpu.  Prints one JSON line per row plus a summary
(--out PATH); the headline is the best sustained block-size throughput
with every frame CRC-validated.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _make_stream(txcfg, n_frames, seed=0):
    """Modulate n_frames QPSK frames into one contiguous host sample
    stream (not timed)."""
    import jax
    import jax.numpy as jnp
    from gr_dtl_jax.models import transmitter

    txp = transmitter.build_tx(txcfg)
    rng = np.random.RandomState(seed)
    maxb = txcfg.max_frame_bytes()
    plen = np.full((n_frames,), txcfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((n_frames, maxb), np.uint8)
    for i in range(n_frames):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen),
        jnp.full((n_frames,), 2, jnp.int32),
        jnp.zeros((n_frames,), jnp.int32),
        jnp.arange(n_frames, dtype=jnp.int32) & 0xFFF,
        jax.random.PRNGKey(seed))
    return np.asarray(out.samples).reshape(-1)


def bench_stream_rx_accumulate(rxcfg, stream, frames_per_block,
                               timed_blocks, warmup=3):
    """Dispatch-only timed region + one tiny value-chained end fetch."""
    import jax
    import jax.numpy as jnp
    from gr_dtl_jax.models import session

    rx = session.StreamRx(rxcfg, frames_per_block=frames_per_block)
    B = rx.block_samples
    total = warmup + timed_blocks
    need = total * B
    reps = -(-need // len(stream))
    s = np.tile(stream, reps)[:need]

    @jax.jit
    def fold(acc, crc_ok, header_ok, valid, acct):
        v = valid
        return acc + jnp.stack([
            jnp.sum((crc_ok & v).astype(jnp.int32)),
            jnp.sum((header_ok & v).astype(jnp.int32)),
            jnp.sum(v.astype(jnp.int32)),
            acct[0],  # lost frames
            acct[1],  # received (header-ok) frames
        ])

    acc = jnp.zeros(5, jnp.int32)
    for i in range(warmup):
        out, valid, acct, _tb = rx._dispatch(s[i * B : (i + 1) * B])
        acc = fold(acc, out.crc_ok, out.header_ok, valid, acct)
    # sync: drain the warmup queue (compiles included) before timing
    np.asarray(acc)
    acc = jnp.zeros(5, jnp.int32)
    t0 = time.monotonic()
    for i in range(warmup, total):
        out, valid, acct, _tb = rx._dispatch(s[i * B : (i + 1) * B])
        acc = fold(acc, out.crc_ok, out.header_ok, valid, acct)
    a = np.asarray(acc)  # value chain: completes only after every block
    elapsed = time.monotonic() - t0
    n_crc, n_hdr, n_valid = int(a[0]), int(a[1]), int(a[2])
    return {
        "mode": "accumulate",
        "frames_per_block": frames_per_block,
        "block_samples": B,
        "timed_blocks": timed_blocks,
        "msamples_per_s": timed_blocks * B / elapsed / 1e6,
        "region_elapsed_s": elapsed,
        "crc_ok": n_crc,
        "header_ok": n_hdr,
        "valid_frames": n_valid,
        "lost": int(a[3]),
    }


def bench_ingest_cost(block_samples, n=16):
    """Pure H2D ingest cost: device_put of block-sized host buffers.

    The transfer is validated (and the value chain closed) by a jitted
    reduce over every uploaded buffer."""
    import jax
    import jax.numpy as jnp

    buf = (np.random.RandomState(0).randn(block_samples).astype(np.float32)
           .view(np.complex64)[: block_samples // 2])
    buf = np.concatenate([buf, buf])[:block_samples].astype(np.complex64)
    nbytes = buf.nbytes

    @jax.jit
    def consume(acc, h):
        return acc + jnp.sum(jnp.abs(h[:: max(1, block_samples // 64)]))

    h = jax.device_put(buf)
    acc = consume(jnp.float32(0), h)
    _ = np.asarray(acc)  # warm compile
    t0 = time.monotonic()
    acc = jnp.float32(0)
    for _ in range(n):
        h = jax.device_put(buf)
        acc = consume(acc, h)
    _ = np.asarray(acc)  # chains every upload
    elapsed = time.monotonic() - t0
    return {
        "mode": "ingest-cost",
        "block_samples": block_samples,
        "block_bytes": nbytes,
        "uploads": n,
        "h2d_ms_per_block": elapsed / n * 1e3,
        "h2d_mbytes_per_s": n * nbytes / elapsed / 1e6,
    }


def bench_ingest_ab(rxcfg, stream, frames_per_block, timed_blocks, warmup=3):
    """Serialized vs double-buffered (prefetch) ingest, accumulate-style
    timed region (no per-block readbacks).  baseline: each block's H2D
    happens inside dispatch.  prefetch: block k+1's device_put is issued
    right after block k's dispatch, overlapping its compute."""
    import jax
    import jax.numpy as jnp
    from gr_dtl_jax.models import session

    rows = []
    for mode in ("serialized", "prefetch"):
        rx = session.StreamRx(rxcfg, frames_per_block=frames_per_block)
        B = rx.block_samples
        total = warmup + timed_blocks
        need = total * B
        reps = -(-need // len(stream))
        s = np.tile(stream, reps)[:need]
        chunks = [s[i * B:(i + 1) * B] for i in range(total)]

        @jax.jit
        def fold(acc, crc_ok, header_ok, valid, acct):
            return acc + jnp.stack([
                jnp.sum((crc_ok & valid).astype(jnp.int32)),
                jnp.sum((header_ok & valid).astype(jnp.int32)),
                jnp.sum(valid.astype(jnp.int32)), acct[0], acct[1]])

        def run(lo, hi, acc):
            if mode == "prefetch":
                handle = rx.prefetch(chunks[lo])
                for i in range(lo, hi):
                    nxt = rx.prefetch(chunks[i + 1]) if i + 1 < hi else None
                    out, valid, acct, _tb = rx._dispatch(handle)
                    acc = fold(acc, out.crc_ok, out.header_ok, valid, acct)
                    handle = nxt
            else:
                for i in range(lo, hi):
                    out, valid, acct, _tb = rx._dispatch(chunks[i])
                    acc = fold(acc, out.crc_ok, out.header_ok, valid, acct)
            return acc
        acc = run(0, warmup, jnp.zeros(5, jnp.int32))
        np.asarray(acc)
        t0 = time.monotonic()
        acc = run(warmup, total, jnp.zeros(5, jnp.int32))
        a = np.asarray(acc)
        elapsed = time.monotonic() - t0
        rows.append({
            "mode": f"ingest-{mode}",
            "frames_per_block": frames_per_block,
            "block_samples": B,
            "timed_blocks": timed_blocks,
            "msamples_per_s": timed_blocks * B / elapsed / 1e6,
            "region_elapsed_s": elapsed,
            "crc_ok": int(a[0]),
            "valid_frames": int(a[2]),
        })
    return rows


def bench_stream_rx_readback(rxcfg, stream, frames_per_block, timed_blocks,
                             warmup=3, depth=1):
    """Deployment-faithful loop: per-block accounting readback.
    depth=1: plain StreamRx (every block's readback serializes the
    loop).  depth>1: StreamRxPipelined — readback of block k overlaps
    block k+1's compute; sustained throughput is wall-clock over the
    whole timed region (per-call medians are meaningless when calls
    alternate dispatch-only and fetch)."""
    from gr_dtl_jax.models import session

    if depth > 1:
        rx = session.StreamRxPipelined(
            rxcfg, frames_per_block=frames_per_block, depth=depth)
    else:
        rx = session.StreamRx(rxcfg, frames_per_block=frames_per_block)
    B = rx.block_samples
    total = warmup + timed_blocks
    need = total * B
    reps = -(-need // len(stream))
    s = np.tile(stream, reps)[:need]

    results = []
    for i in range(warmup):
        r = rx.process(s[i * B : (i + 1) * B])
        if r is not None:
            results.append(r)
    times = []
    results = []
    t_region = time.monotonic()
    for i in range(warmup, total):
        t0 = time.monotonic()
        r = rx.process(s[i * B : (i + 1) * B])
        times.append(time.monotonic() - t0)
        if r is not None:
            results.append(r)
    if depth > 1:
        results.extend(rx.drain())
    elapsed = time.monotonic() - t_region
    last_out, last_valid = results[-1]
    n_ok = int((np.asarray(last_out.crc_ok) & last_valid).sum())
    med = float(np.median(times))
    # plain mode: median per block is the stall-robust estimator.
    # pipelined mode: calls alternate dispatch-only/fetch, so only the
    # whole-region wall clock is meaningful.
    msps = (B / med if depth == 1
            else timed_blocks * B / elapsed) / 1e6
    return {
        "mode": "readback",
        "frames_per_block": frames_per_block,
        "pipeline_depth": depth,
        "block_samples": B,
        "timed_blocks": timed_blocks,
        "msamples_per_s": msps,
        "sec_per_block_median": med,
        "sec_per_block_mean": float(np.mean(times)),
        "sec_per_block_max": float(np.max(times)),
        "region_elapsed_s": elapsed,
        "final_block_crc_ok": n_ok,
        "final_block_frames": int(last_valid.sum()),
    }


def bench_duplex(cfg, rxcfg, frames_per_block, steps, warmup=2,
                 serialize_readback=False):
    """Host full-duplex session: 2x TX + channel + 2x RX per step.
    ``serialize_readback`` selects the fully serialized read ordering
    for A/B comparison against the pipelined default."""
    import jax
    import jax.numpy as jnp
    from gr_dtl_jax.models import session
    from gr_dtl_jax.ops import channel

    def chan(x):
        return channel.awgn(jax.random.PRNGKey(17), jnp.asarray(x), 0.02)

    dpx = session.StreamDuplex(cfg, rxcfg, cfg, rxcfg, chan, chan,
                               frames_per_block=frames_per_block,
                               serialize_readback=serialize_readback)
    rng = np.random.RandomState(3)
    for _ in range(4 * (warmup + steps)):
        dpx.tx_a.send(rng.randint(0, 256, 64).astype(np.uint8).tobytes())
        dpx.tx_b.send(rng.randint(0, 256, 64).astype(np.uint8).tobytes())
    for _ in range(warmup):
        r = dpx.step()
    times = []
    for _ in range(steps):
        t0 = time.monotonic()
        r = dpx.step()
        times.append(time.monotonic() - t0)
        assert r is not None
    med = float(np.median(times))
    # samples moved per step: one block each way
    spb = dpx.tx_a.block_samples + dpx.tx_b.block_samples
    return {
        "frames_per_block": frames_per_block,
        "steps": steps,
        "readback": "serialized" if serialize_readback else "pipelined",
        "msamples_per_s": spb / med / 1e6,
        "sec_per_step_median": med,
        "sec_per_step_max": float(np.max(times)),
    }


def _latency_cols(r):
    """Attach the latency view: dispatch_ms = wall time one dispatch
    takes at the measured sustained rate; buffer_ms_at_700kss = how much
    stream time one dispatch's samples span at the reference's 700 kS/s
    TX rate (ofdm_adaptive_config.py:51) — the real-time buffering
    latency a deployment at that rate pays for this granularity."""
    d = r.get("dispatch_samples", r.get("block_samples"))
    if d and r.get("msamples_per_s"):
        r["dispatch_ms"] = round(d / (r["msamples_per_s"] * 1e6) * 1e3, 3)
        r["buffer_ms_at_700kss"] = round(d / 700e3 * 1e3, 2)
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frame-length", type=int, default=20)
    ap.add_argument("--blocks", type=int, default=12,
                    help="timed blocks per block size")
    ap.add_argument("--sizes", default="16,64,256,1024",
                    help="frames-per-block sweep")
    ap.add_argument("--duplex-steps", type=int, default=8)
    ap.add_argument("--duplex-frames", type=int, default=16)
    ap.add_argument("--mega", default=None,
                    help="megastep rows as FxK pairs (e.g. 16x8,16x64): "
                         "K blocks of F frames per dispatch via the "
                         "in-graph scan (StreamRxMega)")
    ap.add_argument("--ingest", action="store_true",
                    help="ingest rows: H2D cost per block + serialized "
                         "vs double-buffered (prefetch) ingest A/B")
    ap.add_argument("--no-duplex-ab", action="store_true",
                    help="skip the serialized-readback duplex row")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: needs a GPU)")
    args = ap.parse_args()

    from gr_dtl_jax.utils.platform import (card_info, device_summary,
                                           select_platform)

    select_platform(args.cpu, tool="bench_stream")
    from gr_dtl_jax.utils import config as cfgmod

    txcfg = cfgmod.make_tx_config(None, frame_length=args.frame_length)
    rxcfg = cfgmod.make_rx_config(None, frame_length=args.frame_length)

    stream = _make_stream(txcfg, 256)
    rows = []
    for fpb in (int(x) for x in args.sizes.split(",")):
        r = bench_stream_rx_accumulate(rxcfg, stream, fpb, args.blocks)
        assert r["crc_ok"] == r["valid_frames"], (
            "CRC failures in the streamed decode")
        rows.append(_latency_cols(r))
        print(json.dumps({"metric": "stream_rx_throughput", **r}),
              flush=True)
        for depth in (1, 2):
            r = bench_stream_rx_readback(rxcfg, stream, fpb,
                                         args.blocks, depth=depth)
            assert r["final_block_crc_ok"] == r["final_block_frames"], (
                "CRC failures in the streamed decode")
            rows.append(_latency_cols(r))
            print(json.dumps({"metric": "stream_rx_throughput", **r}),
                  flush=True)

    if args.mega:
        for pair in args.mega.split(","):
            fpb, k = (int(x) for x in pair.lower().split("x"))
            from gr_dtl_jax.models import session as _sess

            rx = _sess.StreamRxMega(rxcfg, frames_per_block=fpb,
                                    blocks_per_dispatch=k)
            D = rx.dispatch_samples
            total = (2 + args.blocks) * D
            reps = -(-total // len(stream))
            s = np.tile(stream, reps)[:total]
            for i in range(2):
                rx.process(s[i * D:(i + 1) * D])
            t0 = time.monotonic()
            n_ok = n_valid = 0
            for i in range(2, 2 + args.blocks):
                _o, v = rx.process(s[i * D:(i + 1) * D])
                n_ok += int((v & v.crc_ok).sum())
                n_valid += int(v.sum())
            elapsed = time.monotonic() - t0
            r = {"mode": "mega-host", "frames_per_block": fpb,
                 "blocks_per_dispatch": k, "dispatch_samples": D,
                 "timed_dispatches": args.blocks,
                 "msamples_per_s": args.blocks * D / elapsed / 1e6,
                 "region_elapsed_s": elapsed,
                 "crc_ok": n_ok, "valid_frames": n_valid}
            assert r["crc_ok"] == r["valid_frames"], (
                "CRC failures in the megastep decode")
            rows.append(_latency_cols(r))
            print(json.dumps({"metric": "stream_rx_throughput", **r}),
                  flush=True)

    ingest_rows = []
    if args.ingest:
        fpb0 = int(args.sizes.split(",")[0])
        blk = fpb0 * rxcfg.frame_samples
        ingest_rows.append(bench_ingest_cost(blk))
        print(json.dumps({"metric": "stream_ingest", **ingest_rows[-1]}),
              flush=True)
        for r in bench_ingest_ab(rxcfg, stream, fpb0, args.blocks):
            ingest_rows.append(_latency_cols(r))
            print(json.dumps({"metric": "stream_ingest", **r}),
                  flush=True)

    dpx_rows = []
    if args.duplex_steps > 0:
        orderings = ([False] if args.no_duplex_ab else [True, False])
        for ser in orderings:
            d = bench_duplex(txcfg, rxcfg, args.duplex_frames,
                             args.duplex_steps, serialize_readback=ser)
            dpx_rows.append(d)
            print(json.dumps({"metric": "stream_duplex_throughput", **d}),
                  flush=True)

    best = max(rows, key=lambda r: r["msamples_per_s"])
    result = {
        "device": device_summary(),
        "card": None if args.cpu else card_info(),
        "frame_length": args.frame_length,
        "stream_rx": rows,
        "stream_ingest": ingest_rows,
        "stream_duplex": dpx_rows,
        "best_msamples_per_s": best["msamples_per_s"],
        "best_frames_per_block": best["frames_per_block"],
        "best_mode": best["mode"],
        "note": "host-loop streaming session: per-block H2D transfer, "
                "carried tail/lock state on the device — the "
                "always-on deployment shape.  accumulate rows fold all "
                "accounting on-device and fetch once (value-chained; "
                "zero timed-region readbacks).  readback rows fetch "
                "accounting every block: depth=1 serialized, depth=2 "
                "pipelined (StreamRxPipelined).  duplex rows compare "
                "serialized vs pipelined cross-direction readback.",
    }
    print(json.dumps({"metric": "stream_rx_best", "value":
                      round(best["msamples_per_s"], 1),
                      "unit": "Msamples/s"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
