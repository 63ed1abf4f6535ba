#!/usr/bin/env python3
"""FEC-path benchmark: full coded RX + raw LDPC BP throughput on the GPU.

Two numbers, printed as one JSON line:

- ``coded_rx_msps``: complex samples/s through the complete coded
  receiver (sync + demod + soft LLRs + BP decode + TB reassembly + CRC)
  with the n=300/k=152 demo code — the coded counterpart of bench.py.
- ``ldpc_info_mbps``: raw information throughput (Mbit/s of decoded
  systematic bits) of the batched sum-product BP decoder alone at
  15 iterations, the hot op of the FEC path.

The reference's FEC example runs at 0.4 Msamples/s host rate
(examples/config_fec.json); its decoder does one codeword at a time on
the CPU (awgn_bp).

Needs a GPU unless --cpu (a mechanics check whose numbers say nothing
about the card).

Usage: timeout 900 python tools/bench_fec.py [batch_frames]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import argparse

    from gr_dtl_jax.utils.platform import (card_info, device_summary,
                                           select_platform)

    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=1024)
    ap.add_argument("--out", default=None,
                    help="write the full result as a JSON artifact")
    ap.add_argument("--no-bf16-ab", action="store_true",
                    help="skip the bf16-vs-f32 BP A/B measurement")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (mechanics check; numbers only "
                         "mean something on the GPU)")
    args = ap.parse_args()
    jax = select_platform(args.cpu, tool="bench_fec")
    import jax.numpy as jnp

    from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
    from gr_dtl_jax.ops import channel, constellation as cn, ldpc
    from gr_dtl_jax.models import fec_chain, receiver, transmitter

    B = args.batch
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_path = os.path.join(here, "examples", "config_fec.json")
    cfg = cfgmod.make_tx_config(cfg_path, frame_length=20)
    rxcfg = cfgmod.make_rx_config(cfg_path, frame_length=20)
    name, path = cfg.fec_codes[0]
    H = alist_mod.load_alist(os.path.join(here, path)
                             if not os.path.isabs(path) else path)
    fec = fec_chain.build_fec(cfg, H)
    txp = transmitter.build_tx(cfg, fec)
    rxp = receiver.build_rx(rxcfg, fec)

    rng = np.random.RandomState(0)
    cnst = np.full(B, 2, np.int32)  # QPSK point of the FEC ladder
    plen = np.full(B, int(fec["user_bytes_tab"][2]), np.int32)
    maxb = fec["max_payload_bytes"]
    payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])

    @jax.jit
    def make_stream(payload, plen, cnst, frame_no, key, noise_v):
        out = transmitter.tx_frames(txp, payload, plen, cnst,
                                    jnp.zeros(B, jnp.int32), frame_no, key)
        s = out.samples.reshape(-1)
        return (channel.awgn(jax.random.PRNGKey(1), s, noise_v),
                jnp.mean(jnp.abs(s) ** 2))

    n_samples = B * rxcfg.frame_samples

    # value-chained steps, timed up to the final scalar on the host
    @jax.jit
    def rx_step(s, acc):
        s = s * jnp.exp(1j * acc[0] * 1e-12)
        frames, _ = receiver.detect_and_extract(s, rxcfg, B)
        r = receiver.rx_frames(rxp, frames)
        return jnp.stack([acc[0] + jnp.sum(r.crc_ok).astype(jnp.float32),
                          acc[1] + jnp.mean(r.avg_iters)])

    # calibrate: SNR labels against the MEASURED stream power (QPSK x0.5
    # frames run ~0.28, not the 0.81 of mixed traffic — a fixed-power
    # assumption mislabels the operating point by ~4.5 dB)
    _, sig_p = make_stream(jnp.asarray(payload), jnp.asarray(plen),
                           jnp.asarray(cnst),
                           jnp.arange(B, dtype=jnp.int32) % 4096,
                           jax.random.PRNGKey(0), jnp.float32(0.0))
    sig_p = float(sig_p)

    def coded_point(snr_db, iters=8):
        """One coded-RX measurement at a channel SNR.  The early-exit
        decoder makes throughput SNR-dependent (as the reference's
        awgn_bp convergence stop does): clean air converges in ~0-2
        iterations, the waterfall burns the full budget — so the bench
        reports a sweep, not one flattering point."""
        noise_v = float(np.sqrt(sig_p / 10 ** (snr_db / 10)))
        stream, _ = make_stream(jnp.asarray(payload), jnp.asarray(plen),
                                jnp.asarray(cnst),
                                jnp.arange(B, dtype=jnp.int32) % 4096,
                                jax.random.PRNGKey(0),
                                jnp.float32(noise_v))
        float(rx_step(stream, jnp.zeros(2))[0])
        acc = jnp.zeros(2)
        t0 = time.perf_counter()
        for _ in range(iters):
            acc = rx_step(stream, acc)
        ok = float(acc[0])
        avg_it = float(acc[1]) / iters
        dt = (time.perf_counter() - t0) / iters
        return {"noise_v": round(noise_v, 4), "snr_db": snr_db,
                "msps": round(n_samples / dt / 1e6, 2),
                "step_ms": round(dt * 1e3, 3),
                "crc_rate": round(ok / (iters * B), 4),
                "avg_bp_iters": round(avg_it, 2)}

    # headline: clean air (25 dB); sweep adds the QPSK ladder operating
    # point (11 dB) and the near-cliff regime (6 dB at frame_length 20)
    sweep = [coded_point(s) for s in (25.0, 11.0, 6.0)]
    head = sweep[0]
    coded_msps = head["msps"]
    coded_avg_it = head["avg_bp_iters"]
    coded_ok = head["crc_rate"] * 8 * B
    dt = head["step_ms"] / 1e3
    iters = 8

    # ---- raw BP decoder throughput -----------------------------------
    code = ldpc.build_ldpc(H)
    CW = 2048  # codewords per step
    msg = rng.randint(0, 2, size=(CW, code["K"])).astype(np.float32)

    @jax.jit
    def make_llr(msg, key):
        cws = ldpc.encode(msg, code)
        return ((1.0 - 2.0 * cws.astype(jnp.float32)) * 4.0
                + jax.random.normal(key, cws.shape) * 0.5)

    llr = make_llr(jnp.asarray(msg), jax.random.PRNGKey(2))

    @jax.jit
    def dec_step(llr, acc):
        # matmul-form BP (the production single-code path)
        hard, it, ok = ldpc.decode_mm(llr + acc * 1e-12, code, 15)
        return acc + jnp.sum(ok).astype(jnp.float32)

    float(dec_step(llr, jnp.float32(0)))
    acc = jnp.float32(0)
    t0 = time.perf_counter()
    for _ in range(iters):
        acc = dec_step(llr, acc)
    bp_ok = float(acc)
    dt_bp = (time.perf_counter() - t0) / iters
    info_mbps = CW * code["K"] / dt_bp / 1e6

    # ---- bf16 BP A/B (the measurement that decides the default) ------
    # GR_DTL_BP_BF16 is read at TRACE time inside decode_mm, so a
    # fresh jit closure after flipping the env retraces with bf16
    # incidence matmuls; accuracy cost is pinned separately
    # (examples/bp_bf16_ablation.json: 0.05% FER at the waterfall knee)
    bf16 = None
    if not args.no_bf16_ab:
        prev_bf16 = os.environ.get("GR_DTL_BP_BF16")
        os.environ["GR_DTL_BP_BF16"] = "1"

        @jax.jit
        def dec_step_bf16(llr, acc):
            hard, it, ok = ldpc.decode_mm(llr + acc * 1e-12, code, 15)
            return acc + jnp.sum(ok).astype(jnp.float32)

        float(dec_step_bf16(llr, jnp.float32(0)))
        acc = jnp.float32(0)
        t0 = time.perf_counter()
        for _ in range(iters):
            acc = dec_step_bf16(llr, acc)
        bp_ok_bf16 = float(acc)
        dt_bf16 = (time.perf_counter() - t0) / iters
        if prev_bf16 is None:
            os.environ.pop("GR_DTL_BP_BF16", None)
        else:
            os.environ["GR_DTL_BP_BF16"] = prev_bf16
        bf16 = {
            "bp_step_ms_bf16": round(dt_bf16 * 1e3, 3),
            "bp_step_ms_f32": round(dt_bp * 1e3, 3),
            "speedup_bf16": round(dt_bp / dt_bf16, 3),
            "bp_ok_rate_bf16": round(bp_ok_bf16 / (iters * CW), 4),
        }

    result = {
        "metric": "fec_path_throughput",
        "coded_rx_msps": round(coded_msps, 2),
        "ldpc_info_mbps": round(info_mbps, 2),
        "unit": "Msamples/s | Mbit/s",
        "device": device_summary(),
        "card": card_info() if not args.cpu else None,
        "coded_snr_sweep": sweep,
        "extra": {"frames_per_step": B, "codewords_per_step": CW,
                  "code": f"n={code['N']} k={code['K']}",
                  "coded_avg_bp_iters": round(coded_avg_it, 2),
                  "coded_crc_rate": round(coded_ok / (iters * B), 4),
                  "bp_ok_rate": round(bp_ok / (iters * CW), 4),
                  "coded_step_ms": round(dt * 1e3, 3),
                  "bp_step_ms": round(dt_bp * 1e3, 3),
                  "timing": "value-chained, ends in a host fetch"},
    }
    if bf16 is not None:
        result["bf16_ab"] = bf16
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
