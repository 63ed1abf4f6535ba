#!/usr/bin/env python3
"""Repeated, interleaved bf16-vs-f32 BP A/B — the measurement that
decides the ``GR_DTL_BP_BF16`` default.

Why this tool exists: the single-shot A/B inside bench_fec.py swung
0.98x -> 0.48x -> 1.99x across three regenerations of the same
artifact on the previous hardware — run-to-run variance swamps a
one-point measurement.  This tool measures the two variants *back to
back* (f32 rep, bf16 rep, f32 rep, ...) so both see the same machine
state, repeats the pair ``--reps`` times, and reports
every per-rep time plus medians.  The default question is then decided
by the median of an interleaved sample, not by whichever single point
ran last.

Two LLR regimes, because the early-exit decoder's hot-loop occupancy is
SNR-dependent:

- ``clean``: +-4 LLRs, sigma 0.5 (bench_fec's raw-BP point, ~1-2 iters)
- ``hard``: weak LLRs near the waterfall (~10-15 iters) — the regime
  where the transcendental message-update loop actually runs, i.e.
  where a matmul-precision change could matter.

Both variants decode the SAME device-resident LLR batch.  Needs a GPU
unless --cpu.

Usage:
  python tools/bench_bf16_ab.py --reps 5 --out bp_bf16_ab.json

Ref: lib/dtl/ldpc_dec.cc:24-71 (the decoder whose speed this decides).
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
    ap.add_argument("--reps", type=int, default=5,
                    help="interleaved (f32, bf16) measurement pairs")
    ap.add_argument("--iters", type=int, default=8,
                    help="value-chained decode steps per timed rep")
    ap.add_argument("--cw", type=int, default=2048, help="codewords/step")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from gr_dtl_jax.utils.platform import device_summary, select_platform

    jax = select_platform(args.cpu, tool="bench_bf16_ab")
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

    regimes = {
        # (llr amplitude, noise sigma): clean mirrors bench_fec's raw-BP
        # point; hard pushes most codewords into the full iteration
        # budget so the transcendental loop dominates
        "clean": (4.0, 0.5),
        "hard": (1.6, 1.0),  # ~96% converge, stragglers burn the full
                             # budget -> batch-wide exit never fires early
    }

    def make_decoder(bf16: bool):
        # GR_DTL_BP_BF16 is read at TRACE time inside decode_mm; a
        # fresh closure traced under the flipped env gives a distinct
        # compiled program.  Restore the caller's env afterwards.
        prev = os.environ.get("GR_DTL_BP_BF16")
        os.environ["GR_DTL_BP_BF16"] = "1" if bf16 else "0"
        try:
            @jax.jit
            def dec_step(llr, acc):
                hard, it, ok = ldpc.decode_mm(llr + acc[0] * 1e-12, code, 15)
                return jnp.stack([
                    acc[0] + jnp.sum(ok).astype(jnp.float32),
                    acc[1] + jnp.sum(it).astype(jnp.float32)])

            return dec_step
        finally:
            if prev is None:
                os.environ.pop("GR_DTL_BP_BF16", None)
            else:
                os.environ["GR_DTL_BP_BF16"] = prev

    dec_f32 = make_decoder(False)
    dec_bf16 = make_decoder(True)

    result = {"metric": "bp_bf16_ab", "device": device_summary(),
              "reps": args.reps, "iters_per_rep": args.iters, "cw": CW,
              "code": f"n={code['N']} k={code['K']}",
              "schedule": "interleaved f32/bf16 pairs, value-chained, "
                          "scalar-fetch timed", "regimes": {}}

    for name, (amp, sigma) in regimes.items():
        llr = make_llr(jnp.asarray(msg), jax.random.PRNGKey(2),
                       jnp.float32(amp), jnp.float32(sigma))
        # warm both compiled programs on this operand shape
        stats = {}
        for label, fn in (("f32", dec_f32), ("bf16", dec_bf16)):
            acc = fn(llr, jnp.zeros(2))
            stats[label] = {"ok_rate": round(float(acc[0]) / CW, 4),
                            "avg_iters": round(float(acc[1]) / CW, 2),
                            "ms": []}

        def timed_rep(fn):
            acc = jnp.zeros(2)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                acc = fn(llr, acc)
            float(acc[0])
            return (time.perf_counter() - t0) / args.iters * 1e3

        for rep in range(args.reps):
            stats["f32"]["ms"].append(round(timed_rep(dec_f32), 3))
            stats["bf16"]["ms"].append(round(timed_rep(dec_bf16), 3))

        for label in ("f32", "bf16"):
            ms = stats[label]["ms"]
            stats[label]["median_ms"] = round(statistics.median(ms), 3)
            stats[label]["min_ms"] = round(min(ms), 3)
        med_f32 = stats["f32"]["median_ms"]
        med_bf16 = stats["bf16"]["median_ms"]
        result["regimes"][name] = {
            "llr_amp": amp, "noise_sigma": sigma, **stats,
            "speedup_bf16_median": round(med_f32 / med_bf16, 3),
            "speedup_bf16_min": round(stats["f32"]["min_ms"]
                                      / stats["bf16"]["min_ms"], 3),
        }
        print(f"[{name}] f32 {stats['f32']['ms']} -> {med_f32} ms | "
              f"bf16 {stats['bf16']['ms']} -> {med_bf16} ms | "
              f"speedup {result['regimes'][name]['speedup_bf16_median']}",
              file=sys.stderr)

    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
