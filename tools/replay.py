#!/usr/bin/env python3
"""Recorded-IQ replay: run the full RX chain over a complex64 capture.

BASELINE config 4 (the reference's ADALM-Pluto capture use case): read
raw interleaved complex64 baseband samples, run Schmidl-Cox detection +
CFO recovery + the full demod chain, write a reference-format frame
store and print stats.  Per-frame trigger refinement absorbs timing
drift across the capture; the integer+fractional CFO path handles
oscillator offset.

Usage: replay.py CAPTURE.c64 [--frames N] [--frame-length L]
                 [--store-rx rx.dat] [--fec-config cfg.json] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    p = argparse.ArgumentParser()
    p.add_argument("capture")
    p.add_argument("--frames", type=int, default=None,
                   help="frame count (default: as many as fit)")
    p.add_argument("--frame-length", type=int, default=20)
    p.add_argument("--config", default=None)
    p.add_argument("--store-rx", default=None)
    p.add_argument("--json", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: needs a GPU)")
    args = p.parse_args()

    from gr_dtl_jax.utils.platform import select_platform

    jax = select_platform(args.cpu, tool="replay")
    import jax.numpy as jnp

    from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
    from gr_dtl_jax.models import fec_chain, receiver
    from gr_dtl_jax.ops import metrics

    cfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    fec = None
    if cfg.fec:
        _, path = cfg.fec_codes[0]
        fec = fec_chain.build_fec(cfg, alist_mod.load_alist(path))
    rxp = receiver.build_rx(cfg, fec)

    raw = np.fromfile(args.capture, dtype=np.complex64)
    n_frames = args.frames or max(1, (len(raw) - cfg.frame_samples)
                                  // cfg.frame_samples)
    frames, eps = receiver.detect_and_extract(jnp.asarray(raw), cfg, n_frames)
    rx = receiver.rx_frames(rxp, frames)

    n_lost, n_total, lost_rate = metrics.lost_frames(rx.frame_no, rx.header_ok)
    res = {
        "capture_samples": int(len(raw)),
        "frames": int(n_frames),
        "header_ok_rate": float(np.asarray(rx.header_ok).mean()),
        "crc_ok_rate": float(np.asarray(rx.crc_ok).mean()),
        "est_snr_db": float(np.asarray(rx.snr_db).mean()),
        "mean_cfo_subcarriers": float(np.asarray(eps).mean()),
        "carr_offset": int(np.asarray(rx.carr_offset)[0]),
        "lost_frame_rate": float(lost_rate),
    }
    if args.store_rx:
        from gr_dtl_jax.testbed.frame_store import FrameStore

        with FrameStore(args.store_rx) as s:
            s.store_batch(rx)
    print(json.dumps(res) if args.json else
          "\n".join(f"{k}: {v}" for k, v in res.items()))


if __name__ == "__main__":
    main()
