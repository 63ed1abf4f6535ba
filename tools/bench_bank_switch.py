#!/usr/bin/env python3
"""Measure the matmul-form vs gather-form LDPC bank decoder crossover.

``fec_chain`` routes small code banks to ``ldpc.decode_bank_mm`` (dense
matmul message passing, n_codes x redundant FLOPs) and large banks to
``ldpc.decode_bank`` (gather walks).  This tool measures both forms at
n_codes in {1,2,4,6,8} on the current device; the threshold is
configurable via ``GR_DTL_BANK_MM_MAX`` (see fec_chain).  Needs a GPU
unless --cpu.

Bank composition: n_codes copies of the n=300/k=152 demo code — what
matters for the mm-form's cost is the *bank size* (its dense operators
are the stacked bank), not code diversity.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--codewords", type=int, default=1024)
    ap.add_argument("--sizes", default="1,2,4,6,8")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    from gr_dtl_jax.utils.platform import device_summary, select_platform

    jax = select_platform(args.cpu, tool="bench_bank_switch")
    import jax.numpy as jnp

    from gr_dtl_jax.utils import alist as alist_mod
    from gr_dtl_jax.ops import ldpc

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    H = alist_mod.load_alist(os.path.join(here, "examples",
                                          "n_0300_k_0152.alist"))
    CW = args.codewords
    rng = np.random.RandomState(0)
    rows = []
    for n_codes in (int(x) for x in args.sizes.split(",")):
        bank = ldpc.build_ldpc_bank([H] * n_codes)
        code = ldpc.build_ldpc(H)
        msg = rng.randint(0, 2, size=(CW, code["K"])).astype(np.float32)
        cws = ldpc.encode(jnp.asarray(msg), code)
        llr = ((1.0 - 2.0 * cws.astype(jnp.float32)) * 4.0
               + jax.random.normal(jax.random.PRNGKey(2), cws.shape) * 0.5)
        idx = jnp.asarray(rng.randint(1, n_codes + 1, CW), jnp.int32)

        def timed(fn):
            @jax.jit
            def step(acc, llr, idx):
                _, _, ok = fn(llr + acc * 1e-12, idx, bank, max_iters=15)
                return acc + jnp.sum(ok).astype(jnp.float32)

            float(step(jnp.float32(0), llr, idx))
            acc = jnp.float32(0)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                acc = step(acc, llr, idx)
            ok = float(acc)
            return (time.perf_counter() - t0) / args.iters, ok / (
                args.iters * CW)

        t_mm, ok_mm = timed(ldpc.decode_bank_mm)
        t_g, ok_g = timed(ldpc.decode_bank)
        rows.append({
            "n_codes": n_codes,
            "mm_ms": round(t_mm * 1e3, 3),
            "gather_ms": round(t_g * 1e3, 3),
            "mm_ok_rate": ok_mm,
            "gather_ok_rate": ok_g,
            "mm_wins": t_mm < t_g,
        })
        print(json.dumps(rows[-1]), flush=True)

    crossover = next((r["n_codes"] for r in rows if not r["mm_wins"]), None)
    max_probed = max(r["n_codes"] for r in rows)
    if crossover is not None:
        note = ("mm-form cost grows with bank size (dense stacked "
                "operators); gather-form is bank-size-invariant.  "
                "GR_DTL_BANK_MM_MAX should sit just below the "
                f"measured crossover ({crossover}).")
    else:
        note = ("mm-form won at every probed bank size (max "
                f"{max_probed}); no crossover measured.  "
                "GR_DTL_BANK_MM_MAX defaults are only evidenced up "
                f"to {max_probed} codes — larger banks extrapolate.")
    res = {
        "metric": "bank_decoder_crossover",
        "codewords_per_step": CW,
        "code": "n=300 k=152 (xN copies)",
        "device": device_summary(),
        "rows": rows,
        "max_probed_n_codes": max_probed,
        "measured_crossover_n_codes": crossover,
        "note": note,
    }
    print(json.dumps({"metric": res["metric"],
                      "crossover": crossover}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)


if __name__ == "__main__":
    main()
