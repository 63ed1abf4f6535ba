#!/usr/bin/env python3
"""Coded-path cost breakdown on the GPU: where do the non-BP
milliseconds go (soft LLRs, codeword serialization / de-shortening,
bit unpack, CRC)?  This tool measures the pipeline cumulatively
(value-chained steps, timed up to a host read of the final scalar):

  stage 1: detect_and_extract only           (sync + CFO + window gather)
  stage 2: + rx_frames(defer_fec=True)       (demod + equalize + header
                                              + soft LLRs + serialize)
  stage 3: + fec_frame_decode                (BP + de-shorten + unpack
                                              + CRC)  == full coded RX
  ref    : rx_frames on the uncoded build    (hard-decision demod path)

Differences between consecutive stages give per-stage cost.  Needs a
GPU unless --cpu.  Prints one JSON line; --out writes the artifact.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def timed(fn, *args, iters=8):
    """Value-chained loop over a jitted fn(acc, *args) -> acc."""
    import jax.numpy as jnp

    acc = fn(jnp.float32(0), *args)
    float(acc)  # compile + settle
    acc = jnp.float32(0)
    t0 = time.perf_counter()
    for _ in range(iters):
        acc = fn(acc, *args)
    v = float(acc)
    return (time.perf_counter() - t0) / iters, v


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    from gr_dtl_jax.utils.platform import device_summary, select_platform

    jax = select_platform(args.cpu, tool="profile_fec_breakdown")
    import jax.numpy as jnp

    from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
    from gr_dtl_jax.ops import channel
    from gr_dtl_jax.models import fec_chain, receiver, transmitter

    B = args.frames
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_path = os.path.join(here, "examples", "config_fec.json")
    cfg = cfgmod.make_tx_config(cfg_path, frame_length=20)
    rxcfg = cfgmod.make_rx_config(cfg_path, frame_length=20)
    _, path = cfg.fec_codes[0]
    H = alist_mod.load_alist(os.path.join(here, path)
                             if not os.path.isabs(path) else path)
    fec = fec_chain.build_fec(cfg, H)
    txp = transmitter.build_tx(cfg, fec)
    rxp = receiver.build_rx(rxcfg, fec)
    # uncoded reference build at the same geometry
    ucfg = cfgmod.make_tx_config(None, frame_length=20)
    urxcfg = cfgmod.make_rx_config(None, frame_length=20)
    utxp = transmitter.build_tx(ucfg)
    urxp = receiver.build_rx(urxcfg)

    rng = np.random.RandomState(0)
    cnst = jnp.full((B,), 2, jnp.int32)
    plen = np.full(B, int(fec["user_bytes_tab"][2]), np.int32)
    payload = np.zeros((B, fec["max_payload_bytes"]), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])

    @jax.jit
    def make_stream(payload, plen, key):
        out = transmitter.tx_frames(txp, payload, plen, cnst,
                                    jnp.zeros(B, jnp.int32),
                                    jnp.arange(B, dtype=jnp.int32) % 4096, key)
        return channel.awgn(jax.random.PRNGKey(1), out.samples.reshape(-1),
                            0.05)

    stream = make_stream(jnp.asarray(payload), jnp.asarray(plen),
                         jax.random.PRNGKey(0))
    n_samples = B * rxcfg.frame_samples

    uplen = np.full(B, ucfg.frame_bytes(2) - 4, np.int32)
    upayload = np.zeros((B, ucfg.max_frame_bytes()), np.uint8)
    for i in range(B):
        upayload[i, : uplen[i]] = rng.randint(0, 256, uplen[i])

    @jax.jit
    def make_ustream(payload, plen, key):
        out = transmitter.tx_frames(utxp, payload, plen, cnst,
                                    jnp.zeros(B, jnp.int32),
                                    jnp.arange(B, dtype=jnp.int32) % 4096, key)
        return channel.awgn(jax.random.PRNGKey(1), out.samples.reshape(-1),
                            0.05)

    ustream = make_ustream(jnp.asarray(upayload), jnp.asarray(uplen),
                           jax.random.PRNGKey(0))

    @jax.jit
    def s1_detect(acc, s):
        s = s * jnp.exp(1j * acc * 1e-12)
        frames, eps = receiver.detect_and_extract(s, rxcfg, B)
        return (acc + jnp.sum(jnp.abs(frames[:, 0])) * 1e-9
                + jnp.sum(eps) * 1e-9)

    @jax.jit
    def s2_defer(acc, s):
        s = s * jnp.exp(1j * acc * 1e-12)
        frames, _ = receiver.detect_and_extract(s, rxcfg, B)
        out, fec_in = receiver.rx_frames(rxp, frames, defer_fec=True)
        return acc + jnp.sum(fec_in["llrs"][:, 0]) * 1e-9 + jnp.sum(
            out.header_ok).astype(jnp.float32) * 1e-6

    @jax.jit
    def s3_full(acc, s):
        s = s * jnp.exp(1j * acc * 1e-12)
        frames, _ = receiver.detect_and_extract(s, rxcfg, B)
        r = receiver.rx_frames(rxp, frames)
        return acc + jnp.sum(r.crc_ok).astype(jnp.float32)

    @jax.jit
    def s_uncoded(acc, s):
        s = s * jnp.exp(1j * acc * 1e-12)
        frames, _ = receiver.detect_and_extract(s, urxcfg, B)
        r = receiver.rx_frames(urxp, frames)
        return acc + jnp.sum(r.crc_ok).astype(jnp.float32)

    t1, _ = timed(s1_detect, stream)
    t2, _ = timed(s2_defer, stream)
    t3, ok = timed(s3_full, stream)
    tu, uok = timed(s_uncoded, ustream)

    res = {
        "metric": "fec_breakdown",
        "frames": B,
        "device": device_summary(),
        "samples_per_step": n_samples,
        "detect_ms": round(t1 * 1e3, 3),
        "defer_fec_ms": round(t2 * 1e3, 3),
        "full_coded_ms": round(t3 * 1e3, 3),
        "uncoded_ms": round(tu * 1e3, 3),
        "stage_demod_soft_ms": round((t2 - t1) * 1e3, 3),
        "stage_decode_ms": round((t3 - t2) * 1e3, 3),
        "coded_msps": round(n_samples / t3 / 1e6, 1),
        "uncoded_msps": round(B * urxcfg.frame_samples / tu / 1e6, 1),
        "coded_crc_rate": ok / (8 * B),
        "uncoded_crc_rate": uok / (8 * B),
    }
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)


if __name__ == "__main__":
    main()
