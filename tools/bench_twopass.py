#!/usr/bin/env python3
"""Interleaved A/B: batch-wide-exit BP (decode_mm) vs the two-pass
straggler schedule (decode_mm_twopass).

Same discipline as tools/bench_bf16_ab.py: both compiled variants
decode the SAME device-resident LLR batch back to back, repeated
``--reps`` times, medians decide.  Regimes: clean (early exit at
entry), knee (~96% converge, stragglers burn the budget — where a
straggler schedule could win), waterfall (majority unconverged — where
it cannot).

Needs a GPU unless --cpu.

Usage:
  python tools/bench_twopass.py --reps 5 --out bp_twopass_ab.json

Ref: lib/dtl/ldpc_dec.cc:27 (per-codeword 15-iteration cap semantics).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=8,
                    help="value-chained decode steps per timed rep")
    ap.add_argument("--cw", type=int, default=2048)
    ap.add_argument("--first", type=int, default=3,
                    help="pass-1 iteration budget")
    ap.add_argument("--bucket", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from gr_dtl_jax.utils.platform import device_summary, select_platform

    jax = select_platform(args.cpu, tool="bench_twopass")
    import jax.numpy as jnp

    from gr_dtl_jax.utils import alist as alist_mod
    from gr_dtl_jax.ops import ldpc

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    H = alist_mod.load_alist(
        os.path.join(here, "examples", "n_0300_k_0152.alist"))
    code = ldpc.build_ldpc(H)
    CW = args.cw
    rng = np.random.RandomState(0)
    msg = rng.randint(0, 2, size=(CW, code["K"])).astype(np.float32)

    @jax.jit
    def make_llr(msg, key, amp, sigma):
        cws = ldpc.encode(msg, code)
        return ((1.0 - 2.0 * cws.astype(jnp.float32)) * amp
                + jax.random.normal(key, cws.shape) * sigma)

    regimes = {"clean": (4.0, 0.5), "knee": (1.6, 1.0),
               "waterfall": (1.3, 1.0)}

    @jax.jit
    def step_mm(llr, acc):
        hard, it, ok = ldpc.decode_mm(llr + acc[0] * 1e-12, code, 15)
        return jnp.stack([acc[0] + jnp.sum(ok).astype(jnp.float32),
                          acc[1] + jnp.sum(it).astype(jnp.float32)])

    @jax.jit
    def step_2p(llr, acc):
        hard, it, ok = ldpc.decode_mm_twopass(
            llr + acc[0] * 1e-12, code, 15, first=args.first,
            bucket=args.bucket)
        return jnp.stack([acc[0] + jnp.sum(ok).astype(jnp.float32),
                          acc[1] + jnp.sum(it).astype(jnp.float32)])

    result = {"metric": "bp_twopass_ab",
              "device": device_summary(),
              "reps": args.reps, "iters_per_rep": args.iters, "cw": CW,
              "first": args.first,
              "bucket": args.bucket or max(128, CW // 8),
              "code": f"n={code['N']} k={code['K']}",
              "schedule": "interleaved mm/twopass pairs, value-chained, "
                          "scalar-fetch timed", "regimes": {}}

    for name, (amp, sigma) in regimes.items():
        llr = make_llr(jnp.asarray(msg), jax.random.PRNGKey(2),
                       jnp.float32(amp), jnp.float32(sigma))
        stats = {}
        for label, fn in (("mm", step_mm), ("twopass", step_2p)):
            acc = fn(llr, jnp.zeros(2))
            stats[label] = {"ok_rate": round(float(acc[0]) / CW, 4),
                            "avg_iters": round(float(acc[1]) / CW, 2),
                            "ms": []}

        def timed(fn):
            acc = jnp.zeros(2)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                acc = fn(llr, acc)
            float(acc[0])
            return (time.perf_counter() - t0) / args.iters * 1e3

        for _ in range(args.reps):
            stats["mm"]["ms"].append(round(timed(step_mm), 3))
            stats["twopass"]["ms"].append(round(timed(step_2p), 3))
        for label in ("mm", "twopass"):
            stats[label]["median_ms"] = round(
                statistics.median(stats[label]["ms"]), 3)
        result["regimes"][name] = {
            "llr_amp": amp, "noise_sigma": sigma, **stats,
            "speedup_twopass_median": round(
                stats["mm"]["median_ms"] / stats["twopass"]["median_ms"], 3),
        }
        print(f"[{name}] mm {stats['mm']['ms']} -> "
              f"{stats['mm']['median_ms']} ms | 2p {stats['twopass']['ms']} "
              f"-> {stats['twopass']['median_ms']} ms | speedup "
              f"{result['regimes'][name]['speedup_twopass_median']}",
              file=sys.stderr)

    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
