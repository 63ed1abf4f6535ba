"""Benchmark: batch OFDM receive throughput on one GPU.

Prints ONE JSON line:
  {"metric": "ofdm_demod_throughput", "value": X, "unit": "Msamples/s",
   "device": {...}, "card": "...", "extra": {...}}

The metric counts complex baseband samples fully demodulated per second
through the *complete* receiver: Schmidl-Cox detection over the raw
stream + frame extraction + CFO correction + DFT + carrier-offset
search + channel estimation + 2-pass decision-directed equalizer +
header parse + adaptive demap + repack + CRC32 verify.

The input is the served path's: samples made on the host (TX on the
device, AWGN added on the host) and moved to the device with
``jax.device_put`` every step; the decoded bytes and CRC flags come
back to the host, so each step ends with its results on the host.  The
run fails without a GPU.

Usage: python bench.py [--frames 2048] [--windows 5] [--iters 10]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NOISE_VOLTAGE = 0.02  # AWGN amplitude: E|n|^2 = 4e-4, about 33 dB SNR


def make_batch(n_frames: int = 2048, frame_length: int = 20,
               noise_voltage: float = NOISE_VOLTAGE, seed: int = 0):
    """One mixed-MCS (BPSK..QAM16) frame batch as a host sample stream.

    Returns a dict: ``cfg`` (RxConfig), ``rxp`` (receiver constants),
    ``stream`` [n_frames * frame_samples + 2048] complex64 numpy,
    ``payload`` [B, max_bytes] uint8, ``payload_len`` [B],
    ``cnst`` [B] and ``tx_crc`` [B] uint32 (the CRC32 the transmitter
    appended to each frame).
    """
    import jax
    import jax.numpy as jnp

    from gr_dtl_jax.models import receiver, transmitter
    from gr_dtl_jax.ops import constellation as cn
    from gr_dtl_jax.utils import config as cfgmod

    B = n_frames
    cfg = cfgmod.make_rx_config(None, frame_length=frame_length)
    txcfg = cfgmod.make_tx_config(None, frame_length=frame_length)
    txp = transmitter.build_tx(txcfg)
    rng = np.random.RandomState(seed)
    cnst = rng.randint(1, 5, size=B).astype(np.int32)
    plen = np.array([txcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[c])) - 4
                     for c in cnst], np.int32)
    payload = np.zeros((B, txcfg.max_frame_bytes()), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])

    @jax.jit
    def tx(payload, plen, cnst, key):
        out = transmitter.tx_frames(
            txp, payload, plen, cnst, jnp.zeros(B, jnp.int32),
            jnp.arange(B, dtype=jnp.int32) % 4096, key)
        return out.samples.reshape(-1), out.frame_bytes

    samples, frame_bytes = jax.device_get(
        tx(payload, plen, cnst, jax.random.PRNGKey(seed)))
    # CRC32 trailer, little-endian, right after each payload
    idx = plen[:, None] + np.arange(4)[None, :]
    trailer = np.take_along_axis(frame_bytes, idx, axis=1).astype(np.uint32)
    tx_crc = (trailer << (8 * np.arange(4, dtype=np.uint32))).sum(
        axis=1).astype(np.uint32)
    # pad so the last frame's window never clips, then the channel
    s = np.concatenate([samples, np.zeros(2048, np.complex64)])
    noise = rng.randn(2, s.size) * (noise_voltage / np.sqrt(2))
    s = (s + noise[0] + 1j * noise[1]).astype(np.complex64)
    return {"cfg": cfg, "rxp": receiver.build_rx(cfg), "stream": s,
            "payload": payload, "payload_len": plen, "cnst": cnst,
            "tx_crc": tx_crc}


def build_step(cfg, rxp, n_frames: int):
    """Jitted batch receive: [N] complex64 stream -> RxOut."""
    import jax

    from gr_dtl_jax.models import receiver

    @jax.jit
    def step(stream):
        frames, _ = receiver.detect_and_extract(stream, cfg, n_frames)
        return receiver.rx_frames(rxp, frames)

    return step


def served_step(step, host_stream):
    """Host samples in; (payload, payload_len, crc_ok) out, on the host."""
    import jax

    r = step(jax.device_put(host_stream))
    return jax.device_get((r.payload, r.payload_len, r.crc_ok))


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=2048,
                   help="frames per step")
    p.add_argument("--windows", type=int, default=5)
    p.add_argument("--iters", type=int, default=10,
                   help="steps per window")
    args = p.parse_args(argv)

    from gr_dtl_jax.utils.platform import (card_info, device_summary,
                                           select_platform)

    select_platform(tool="bench.py")
    card = card_info()
    b = make_batch(args.frames)
    step = build_step(b["cfg"], b["rxp"], args.frames)
    t0 = time.perf_counter()
    served_step(step, b["stream"])
    first_s = time.perf_counter() - t0
    ms = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            _, _, crc_ok = served_step(step, b["stream"])
        ms.append((time.perf_counter() - t0) / args.iters * 1e3)
    step_ms = float(np.median(ms))
    n_samples = args.frames * b["cfg"].frame_samples
    print(json.dumps({
        "metric": "ofdm_demod_throughput",
        "value": n_samples / step_ms / 1e3,
        "unit": "Msamples/s",
        "device": device_summary(),
        "card": card,
        "extra": {"frames_per_step": args.frames,
                  "crc_ok_rate": float(np.mean(crc_ok)),
                  "step_ms_median": step_ms, "step_ms_windows": ms,
                  "first_step_s": first_s,
                  "timing": "host-fed served step, median of windows"},
    }))


if __name__ == "__main__":
    main()
