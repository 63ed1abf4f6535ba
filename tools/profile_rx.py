#!/usr/bin/env python3
"""Profiler trace capture for the modem chains on the GPU (SURVEY.md §5
tracing).

The reference's only tracing is timestamped per-block logs mined by
log.sh; here the profiler is the real thing: this tool runs the chosen
chain a few times under ``jax.profiler.trace`` and writes a TensorBoard
/ Perfetto-compatible trace (HLO ops, fusion boundaries, HBM transfers)
for kernel-level performance work.

    python tools/profile_rx.py --out dtl_trace            # full RX
    python tools/profile_rx.py --fec --frames 128         # coded RX
    tensorboard --logdir dtl_trace                        # then open

Needs a GPU unless --cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="dtl_trace",
                    help="trace output directory (TensorBoard logdir)")
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--frame-length", type=int, default=20)
    ap.add_argument("--fec", action="store_true", help="profile the coded path")
    ap.add_argument("--steps", type=int, default=3,
                    help="traced executions after warmup")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: needs a GPU)")
    args = ap.parse_args()

    from gr_dtl_jax.utils.platform import select_platform

    jax = select_platform(args.cpu, tool="profile_rx")
    import jax.numpy as jnp

    from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
    from gr_dtl_jax.ops import channel, constellation as cn
    from gr_dtl_jax.models import fec_chain, receiver, transmitter

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.fec:
        cfg_path = os.path.join(here, "examples", "config_fec.json")
        cfg = cfgmod.make_tx_config(cfg_path, frame_length=args.frame_length)
        rxcfg = cfgmod.make_rx_config(cfg_path, frame_length=args.frame_length)
        fec = fec_chain.build_fec(
            cfg, [alist_mod.load_alist(os.path.join(here, p))
                  for _, p in cfg.fec_codes])
    else:
        cfg = cfgmod.make_tx_config(None, frame_length=args.frame_length)
        rxcfg = cfgmod.make_rx_config(None, frame_length=args.frame_length)
        fec = None
    txp = transmitter.build_tx(cfg, fec)
    rxp = receiver.build_rx(rxcfg, fec)

    B = args.frames
    rng = np.random.RandomState(0)
    cnst = np.full(B, 2, np.int32)
    if fec is not None:
        maxb = fec["max_payload_bytes"]
        plen = np.full(B, int(fec["user_bytes_tab"][2]), np.int32)
    else:
        maxb = cfg.max_frame_bytes()
        plen = np.full(B, cfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])

    @jax.jit
    def make_stream(payload, plen, cnst, frame_no, key):
        out = transmitter.tx_frames(txp, payload, plen, cnst,
                                    jnp.zeros(B, jnp.int32), frame_no, key)
        return channel.awgn(jax.random.PRNGKey(1), out.samples.reshape(-1),
                            0.02)

    stream = make_stream(jnp.asarray(payload), jnp.asarray(plen),
                         jnp.asarray(cnst),
                         jnp.arange(B, dtype=jnp.int32) % 4096,
                         jax.random.PRNGKey(0))

    @jax.jit
    def rx_full(s):
        frames, _ = receiver.detect_and_extract(s, rxcfg, B)
        return receiver.rx_frames(rxp, frames)

    jax.block_until_ready(rx_full(stream))  # compile outside the trace
    with jax.profiler.trace(args.out):
        for _ in range(args.steps):
            out = rx_full(stream)
        jax.block_until_ready(out)
    print(f"trace written to {args.out} "
          f"({'coded' if args.fec else 'plain'} RX, {args.steps} steps, "
          f"{B} frames/step); open with: tensorboard --logdir {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
