#!/usr/bin/env python3
"""Long-run soak of the always-on daemons: stream-tx -> impaired link
-> stream, for 1e8+ samples, with a JSONL health record.

The reference gets "runs forever" from the GNU Radio scheduler; here
the evidence is empirical: the two *deployment entry points*
(``run_modem stream-tx`` and ``run_modem stream`` — real OS processes,
real TCP sample stream) run for hundreds of millions of samples through
a continuously impaired channel while this driver records, over time,

  - header / payload-CRC success counters (RX daemon ``--stats-every``
    self-report),
  - the lost-frame rate (12-bit frame_no gap accounting),
  - both daemons' resident set size (a leak in the carried-state
    host loop or the device buffers shows up as RSS growth),

to ``--jsonl``, plus a pass/fail summary to ``--out``.

The impairment relay (in this process) applies, per chunk, with state
carried continuously across chunks:

  - AWGN at ``--snr-db``,
  - a slowly wandering CFO (sinusoidal, +-``--cfo-max`` subcarriers
    over ``--cfo-period`` samples — oscillator drift),
  - a constant sample-clock offset (``--sfo-ppm``, linear-interp
    resampler) — the accumulated timing drift is what keeps the
    trigger-repair lock logic honest over 1e8 samples (the reference's
    frame_detect fix_sync, ofdm_adaptive_frame_detect_bb_impl.cc).

Pass criteria: RX stays locked (final CRC rate >= --min-crc-rate on
payload frames), lost-frame rate <= --max-lost-rate, and neither
daemon's RSS grew by more than --max-rss-growth-mb between the first
and last quartile of the run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def proc_rss_mb(pid: int) -> float | None:
    try:
        with open(f"/proc/{pid}/statm") as f:
            mb = int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE") / 1e6
        return mb if mb > 1.0 else None  # 0 = zombie/exited
    except (OSError, ValueError):
        return None


class ImpairRelay:
    """TX socket -> (SFO resample + CFO wander + AWGN) -> RX socket."""

    def __init__(self, snr_db, cfo_max_sc, cfo_period, sfo_ppm, fft_len=64,
                 seed=0):
        self.noise_v = float(np.sqrt(0.81 / 10 ** (snr_db / 10)))
        self.cfo_max = cfo_max_sc * 2 * np.pi / fft_len  # rad/sample
        self.cfo_period = float(cfo_period)
        self.step = 1.0 + sfo_ppm * 1e-6
        self.rng = np.random.RandomState(seed)
        self.n_in = 0  # input-clock sample counter (CFO phase source)
        self.phase = 0.0  # accumulated CFO phase, continuous
        self.buf = np.zeros(0, np.complex64)  # resampler holdover
        self.pos = 0.0  # fractional read position into buf

    def __call__(self, chunk: np.ndarray) -> np.ndarray:
        # CFO: integrate the wandering frequency over this chunk
        k = self.n_in + np.arange(len(chunk))
        freq = self.cfo_max * np.sin(2 * np.pi * k / self.cfo_period)
        ph = self.phase + np.cumsum(freq)
        self.phase = float(ph[-1]) if len(ph) else self.phase
        self.n_in += len(chunk)
        x = chunk * np.exp(1j * ph).astype(np.complex64)
        # SFO: linear-interp resample at (1 + ppm) with carried position
        self.buf = np.concatenate([self.buf, x])
        n_out = int((len(self.buf) - 1 - self.pos) / self.step)
        if n_out <= 0:
            return np.zeros(0, np.complex64)
        t = self.pos + self.step * np.arange(n_out)
        i0 = t.astype(np.int64)
        fr = (t - i0).astype(np.float32)
        y = (self.buf[i0] * (1 - fr) + self.buf[i0 + 1] * fr)
        consumed = int(t[-1])  # keep [consumed:] for continuity
        self.pos = t[-1] + self.step - consumed
        self.buf = self.buf[consumed:]
        # AWGN
        y = y + (self.noise_v / np.sqrt(2)) * (
            self.rng.standard_normal(n_out)
            + 1j * self.rng.standard_normal(n_out))
        return y.astype(np.complex64)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--samples", type=float, default=1.5e8,
                    help="TX sample budget (>=1e8 for a real soak)")
    ap.add_argument("--frame-length", type=int, default=20)
    ap.add_argument("--frames-per-block", type=int, default=16)
    ap.add_argument("--pdu-bytes", type=int, default=40)
    ap.add_argument("--snr-db", type=float, default=18.0)
    ap.add_argument("--cfo-max", type=float, default=0.35,
                    help="CFO wander amplitude (subcarriers)")
    ap.add_argument("--cfo-period", type=float, default=2e7,
                    help="CFO wander period (samples)")
    ap.add_argument("--sfo-ppm", type=float, default=20.0)
    ap.add_argument("--stats-every", type=int, default=200,
                    help="RX stats interval (blocks)")
    ap.add_argument("--min-crc-rate", type=float, default=0.98)
    ap.add_argument("--max-lost-rate", type=float, default=0.02)
    ap.add_argument("--max-rss-growth-mb", type=float, default=64.0)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--jsonl", default="SOAK_r04.jsonl")
    ap.add_argument("--out", default="SOAK_r04.json")
    ap.add_argument("--gpu", action="store_true",
                    help="run the RX daemon on the GPU (the TX daemon "
                         "stays on the CPU: one JAX process per card); "
                         "default: both on the CPU")
    args = ap.parse_args()

    from gr_dtl_jax.testbed import sample_io

    frame_samples = (args.frame_length + 3) * 80  # fft64+cp16, 2 sync + hdr
    block = args.frames_per_block * frame_samples
    n_blocks = int(args.samples / block) + 1
    total_samples = n_blocks * block
    # enough PDUs that every frame carries payload (BPSK capacity is
    # the smallest; whole-PDU packing => ~2 fit per frame)
    n_pdus = 3 * n_blocks * args.frames_per_block

    env = dict(os.environ)
    env["RUN_MODEM_CPU"] = "1"
    rx_env = env
    if args.gpu:
        rx_env = {k: v for k, v in env.items() if k != "RUN_MODEM_CPU"}

    import socket as _socket

    ports = []
    for _ in range(2):
        s = _socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    rx_port, tx_port = ports

    rx_cmd = [sys.executable, os.path.join(HERE, "run_modem.py"), "stream",
              "--source", f"listen:{rx_port}",
              "--frame-length", str(args.frame_length),
              "--frames-per-block", str(args.frames_per_block),
              "--pipeline-depth", str(args.pipeline_depth),
              "--stats-every", str(args.stats_every), "--json"]
    rxp = subprocess.Popen(rx_cmd, env=rx_env, stdout=subprocess.PIPE,
                           stderr=subprocess.DEVNULL, text=True, cwd=ROOT)

    # relay: connect to RX (retries until its listener is up), then
    # listen for TX
    rx_ep = sample_io.connect("127.0.0.1", rx_port, timeout=180.0)
    srv, _ = sample_io.listen("127.0.0.1", tx_port)

    tx_cmd = [sys.executable, os.path.join(HERE, "run_modem.py"),
              "stream-tx", "--sink", f"tcp:127.0.0.1:{tx_port}",
              "--frame-length", str(args.frame_length),
              "--frames-per-block", str(args.frames_per_block),
              "--pdus", str(n_pdus), "--pdu-bytes", str(args.pdu_bytes),
              "--max-blocks", str(n_blocks), "--json"]
    txp = subprocess.Popen(tx_cmd, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.DEVNULL, text=True, cwd=ROOT)
    tx_ep = sample_io.accept_endpoint(srv, timeout=180.0)
    srv.close()

    impair = ImpairRelay(args.snr_db, args.cfo_max, args.cfo_period,
                         args.sfo_ppm)

    def relay():
        try:
            while True:
                chunk = tx_ep.source.read(block)
                if len(chunk) == 0:
                    break
                y = impair(chunk)
                if len(y):
                    rx_ep.sink.write(y)
                if len(chunk) < block:
                    break
        finally:
            tx_ep.close()
            rx_ep.close()  # EOF -> RX daemon drains and reports

    rt = threading.Thread(target=relay, daemon=True)
    rt.start()

    # collect: RX stats lines + periodic RSS of both daemons
    records = []
    final = None
    t0 = time.monotonic()
    jsonl = open(args.jsonl, "w")
    try:
        for line in rxp.stdout:
            line = line.strip()
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if rec.get("stat") == "stream":
                rec["wall_s"] = round(time.monotonic() - t0, 1)
                rec["rss_tx_mb"] = proc_rss_mb(txp.pid)
                records.append(rec)
                jsonl.write(json.dumps(rec) + "\n")
                jsonl.flush()
                print(json.dumps(rec), flush=True)
            elif rec.get("mode") == "stream":
                final = rec
    finally:
        jsonl.close()
    rt.join(timeout=60)
    txp.wait(timeout=300)
    rxp.wait(timeout=300)

    assert final is not None, "RX daemon did not report a final summary"
    # health: RSS growth between first and last quartile of records
    def growth(key):
        vals = [r[key] for r in records if r.get(key) is not None]
        if len(vals) < 8:
            return 0.0
        q = max(1, len(vals) // 4)
        return float(np.mean(vals[-q:]) - np.mean(vals[:q]))

    crc_rate = (final["frames_crc_ok"] / max(1, final["frames_header_ok"]))
    summary = {
        "samples": final["samples"],
        "blocks": final["blocks"],
        "wall_s": records[-1]["wall_s"] if records else None,
        "frames_header_ok": final["frames_header_ok"],
        "frames_crc_ok": final["frames_crc_ok"],
        "crc_rate_of_decoded": crc_rate,
        "lost_frame_rate": final["lost_frame_rate"],
        "rss_rx_growth_mb": round(growth("rss_mb"), 1),
        "rss_tx_growth_mb": round(growth("rss_tx_mb"), 1),
        "impairments": {"snr_db": args.snr_db,
                        "cfo_max_subcarriers": args.cfo_max,
                        "cfo_period_samples": args.cfo_period,
                        "sfo_ppm": args.sfo_ppm},
        "platform": final["platform"],  # the RX daemon's device
        "pipeline_depth": args.pipeline_depth,
        "records": len(records),
        "jsonl": args.jsonl,
        "pass": bool(
            final["samples"] >= 1e8
            and crc_rate >= args.min_crc_rate
            and final["lost_frame_rate"] <= args.max_lost_rate
            and growth("rss_mb") <= args.max_rss_growth_mb
            and growth("rss_tx_mb") <= args.max_rss_growth_mb),
    }
    print(json.dumps(summary, indent=2))
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    sys.exit(0 if summary["pass"] else 1)


if __name__ == "__main__":
    main()
