#!/usr/bin/env python3
"""Proof that the modem's main paths run on one GPU, in one process.

Phases, each through the entry points a user calls:

  a. device     JAX platform, device kind and count, the card's name and
                power limit; anything but a GPU is refused.
  e. reference  the DFT, the Schmidl-Cox metric and the matmul-form LDPC
                decoder against plain float64 references at the batch
                widths, then the uncoded BER-parity points
                (tools/ber_curve.PARITY_POINTS) against AWGN theory.
  b. batch      bench.py's batch: 2048 frames x 20 symbols, mixed
                BPSK..QAM16, fed from the host with ``jax.device_put``;
                every CRC passes, the bytes equal those sent, and a host
                ``zlib.crc32`` agrees with the device CRC on every frame.
  c. coded      LDPC n=300/k=152, 1024 frames at the 11 dB ladder point:
                the ladder's FER bound at ideal timing
                (tools/ber_curve.run_point), then ``run_modem loopback``
                on examples/config_fec.json through the full sync chain,
                where every CRC verdict is checked against the bytes.
  d. stream     ``run_modem stream-tx`` writes a capture from the PDU
                queue; ``run_modem stream`` receives it at F=16, F=16
                with megastep K=4, and F=1024.

With ``--four-cards`` only this runs (on four GPUs):

  f. sharded    ``run_modem stream-sharded`` over 64 streams at F=16 for 3
                chained blocks on a 4x1 and a 2x2 (stream, time) mesh,
                byte for byte against per-stream ``StreamRx`` on one card.

Each phase prints one JSON line of readings from this card (compile
seconds, steady step time, peak device memory).  They are informational,
not benchmark results.  The last line is the verdict:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
A failed phase raises, so no verdict is printed and the exit code is not 0.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

FEC_CONFIG = os.path.join(ROOT, "examples", "config_fec.json")
FEC_ALIST = os.path.join(ROOT, "examples", "n_0300_k_0152.alist")

# reference-phase tolerances (the DFT's depends on the GEMM precision)
DFT_REL_TOL = {"DEFAULT": 2e-3, "HIGHEST": 1e-5}
METRIC_P_TOL = 1e-4  # times max|P|
METRIC_M_TOL = 1e-3


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _emit(phase: str, readings: dict, context: dict):
    print(json.dumps({"phase": phase, "readings_from_this_card": True,
                      **context, **readings,
                      "peak_bytes_in_use": _peak_bytes()}), flush=True)


def _modem(argv):
    """Parse ``run_modem`` arguments as its command line would."""
    import run_modem

    return run_modem, run_modem.parse_args(argv)


# ---------------------------------------------------------------------------
def phase_batch(frames: int = 2048, frame_length: int = 20) -> dict:
    import bench

    b = bench.make_batch(frames, frame_length)
    step = bench.build_step(b["cfg"], b["rxp"], frames)
    t0 = time.perf_counter()
    payload, plen, crc_ok = bench.served_step(step, b["stream"])
    compile_s = time.perf_counter() - t0
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        payload, plen, crc_ok = bench.served_step(step, b["stream"])
        ms.append((time.perf_counter() - t0) * 1e3)

    assert crc_ok.all(), f"{int((~crc_ok).sum())} of {frames} CRCs failed"
    sent_len = b["payload_len"]
    assert (plen == sent_len).all(), "payload lengths differ from those sent"
    for i in range(frames):
        sent = b["payload"][i, : sent_len[i]].tobytes()
        got = payload[i, : plen[i]].tobytes()
        assert got == sent, f"frame {i}: bytes differ from those sent"
        # the device CRC generator agrees with zlib, and the host oracle
        # on the received bytes agrees with the device's crc_ok
        assert zlib.crc32(sent) == int(b["tx_crc"][i]), f"frame {i}: TX CRC"
        assert (zlib.crc32(got) == int(b["tx_crc"][i])) == bool(crc_ok[i])
    return {"frames": frames, "samples_per_step": int(b["stream"].size),
            "compile_s": compile_s, "step_ms": float(np.median(ms)),
            "crc_ok": int(crc_ok.sum())}


def phase_coded(frames: int = 1024, snr_db: float = 11.0,
                frame_length: int = 20) -> dict:
    """The LDPC n=300/k=152 path at the FEC ladder's QPSK point, twice:
    at ideal frame timing as the ladder bound is defined
    (tools/ber_curve.FEC_POINTS, frame_length 10), and through the full
    ``run_modem loopback`` chain on examples/config_fec.json."""
    from ber_curve import FEC_MAX_FER, run_point

    from gr_dtl_jax.ops import constellation as cn

    pt = run_point(2, snr_db, frames, seed=31 + 2, frame_length=10,
                   fec_alist=FEC_ALIST)
    assert pt["fer"] <= FEC_MAX_FER, (
        f"ladder point FER {pt['fer']} above {FEC_MAX_FER} at {snr_db} dB")
    assert pt["undetected_errors"] == 0, pt

    rm, args = _modem(["loopback", "--config", FEC_CONFIG,
                       "--frames", str(frames), "--snr-db", str(snr_db),
                       "--mcs-id", "1", "--frame-length", str(frame_length),
                       "--json"])
    res, (payload, plen), rx = rm.loopback(args)
    assert int(rx.cnst_id[0]) == int(cn.ConstellationType.QPSK)
    crc_ok = np.asarray(rx.crc_ok)
    got, got_len = np.asarray(rx.payload), np.asarray(rx.payload_len)
    bytes_ok = np.zeros(frames, bool)
    for i in range(frames):
        sent = payload[i, : plen[i]].tobytes()
        rcvd = got[i, : got_len[i]].tobytes()
        # the host CRC of what arrived matches what was sent
        bytes_ok[i] = rcvd == sent and zlib.crc32(rcvd) == zlib.crc32(sent)
    # a passed CRC never hides wrong bytes; a failed one may sit on
    # correct payload bytes (errors only in the CRC trailer)
    assert bytes_ok[crc_ok].all(), "crc_ok set on frames with wrong bytes"
    return {"frames": frames, "snr_db": snr_db,
            "ladder_point_fer": pt["fer"], "fer_bound": FEC_MAX_FER,
            "loopback_frame_length": frame_length,
            "loopback_fer": 1.0 - float(crc_ok.mean()),
            "loopback_bytes_ok_crc_failed": int((bytes_ok & ~crc_ok).sum()),
            "compile_s": res["first_call_s"], "step_ms": res["step_ms"]}


def phase_stream(workdir: str, frame_length: int = 20,
                 shapes=((16, 1), (16, 4), (1024, 1)),
                 data_blocks: int = 4) -> list[dict]:
    from gr_dtl_jax.testbed.frame_store import read_frames
    from gr_dtl_jax.utils import config as cfgmod

    F_tx = max(f * k for f, k in shapes)
    cap_bytes = cfgmod.make_tx_config(
        None, frame_length=frame_length).frame_bytes(1) - 4
    pdu_bytes = max(1, cap_bytes // 2)
    pdus = 2 * data_blocks * F_tx  # two PDUs per BPSK frame
    capture = os.path.join(workdir, "capture.c64")
    tx_store = os.path.join(workdir, "tx.dat")
    rm, args = _modem([
        "stream-tx", "--sink", f"file:{capture}",
        "--frame-length", str(frame_length),
        "--frames-per-block", str(F_tx), "--pdus", str(pdus),
        "--pdu-bytes", str(pdu_bytes), "--store-tx", tx_store,
        # one block of empty frames after the data lets every data frame
        # finish inside the receiver's last block
        "--max-blocks", str(data_blocks + 1), "--json"])
    tx_res = rm.run_stream_tx(args)
    sent = dict(read_frames(tx_store))
    assert tx_res["payload_frames"] == len(sent) == data_blocks * F_tx
    assert sum(len(v) for v in sent.values()) == pdus * pdu_bytes

    out = []
    for F, K in shapes:
        rx_store = os.path.join(workdir, f"rx_{F}_{K}.dat")
        _, args = _modem([
            "stream", "--source", f"file:{capture}",
            "--frame-length", str(frame_length),
            "--frames-per-block", str(F), "--blocks-per-dispatch", str(K),
            "--store-rx", rx_store, "--json"])
        res = rm.run_stream(args)
        got = {no: p for no, p in read_frames(rx_store) if p}
        assert got == sent, (f"F={F} K={K}: {len(got)} data frames received,"
                             f" {len(sent)} sent, or bytes differ")
        assert res["lost_frames"] == 0, res
        assert res["frames_crc_ok"] == res["frames_header_ok"], res
        out.append({"frames_per_block": F, "blocks_per_dispatch": K,
                    "blocks": res["blocks"], "pdus": pdus,
                    "compile_s": res["first_block_s"],
                    "step_ms": res["block_ms_median"],
                    "msamples_per_s": res["msamples_per_s"]})
    return out


def phase_reference(frames: int = 2048, frame_length: int = 20,
                    codewords: int = 2048, ber_points=None) -> dict:
    import jax
    import jax.numpy as jnp

    import bench
    from ber_curve import MAX_LOSS_DB, PARITY_POINTS, run_point

    from gr_dtl_jax.ops import ldpc, ofdm, sync
    from gr_dtl_jax.utils import alist as alist_mod

    failures = []
    out = {}
    rng = np.random.RandomState(7)
    b = bench.make_batch(frames, frame_length)
    cfg = b["cfg"]

    # DFT / IDFT on [B * symbols, 64] against float64 np.fft
    rows = frames * cfg.frame_ofdm_symbols
    x = (rng.randn(rows, 64) + 1j * rng.randn(rows, 64)).astype(np.complex64)
    x64 = x.astype(np.complex128)
    refs = {"dft": np.fft.fftshift(np.fft.fft(x64, norm="ortho"), axes=-1),
            "idft": np.fft.ifft(np.fft.ifftshift(x64, axes=-1), norm="ortho")}
    prec = ofdm.DFT_PRECISION.name
    for name, fn, inverse in (("dft", ofdm.ofdm_demodulate, False),
                              ("idft", ofdm.ofdm_modulate, True)):
        op = jax.jit(fn)
        t0 = time.perf_counter()
        got = np.asarray(op(x))
        compile_s = time.perf_counter() - t0
        xd = jax.device_put(x)
        jax.block_until_ready(op(xd))
        t0 = time.perf_counter()
        jax.block_until_ready(op(xd))
        step_ms = (time.perf_counter() - t0) * 1e3
        err = float(np.linalg.norm(got - refs[name])
                    / np.linalg.norm(refs[name]))
        other = "HIGHEST" if prec == "DEFAULT" else "DEFAULT"
        alt = np.asarray(jax.jit(lambda v: jnp.matmul(
            v, jnp.asarray(ofdm.dft_matrix(64, inverse)),
            precision=jax.lax.Precision[other]))(x))
        out[name] = {"shape": [rows, 64], "precision": prec,
                     "compile_s": compile_s, "step_ms": step_ms,
                     "rel_err": err, "tol": DFT_REL_TOL[prec],
                     f"rel_err_at_{other}": float(
                         np.linalg.norm(alt - refs[name])
                         / np.linalg.norm(refs[name]))}
        if not err <= DFT_REL_TOL[prec]:
            failures.append(f"{name} rel_err {err} > {DFT_REL_TOL[prec]}")

    # Schmidl-Cox metric on the batch stream against direct float64 sums
    r = b["stream"]
    P, M = jax.jit(sync.timing_metric)(jax.device_put(r))
    P, M = np.asarray(P), np.asarray(M)
    r64 = r.astype(np.complex128)
    n_out = r64.size - 64

    def win(v):
        c = np.concatenate([[0.0], np.cumsum(v)])
        return c[32:] - c[:-32]

    P_ref = win(np.conj(r64[:-32]) * r64[32:])[:n_out]
    E = win(np.abs(r64) ** 2)
    M_ref = np.abs(P_ref) ** 2 / np.maximum(E[:n_out] * E[32:32 + n_out],
                                            1e-12)
    p_err = float(np.max(np.abs(P - P_ref)) / np.max(np.abs(P_ref)))
    m_err = float(np.max(np.abs(M - M_ref)))
    out["timing_metric"] = {"samples": int(r.size), "precision": "n/a",
                            "P_err_rel_to_max": p_err, "P_tol": METRIC_P_TOL,
                            "M_err": m_err, "M_tol": METRIC_M_TOL}
    if not (p_err <= METRIC_P_TOL and m_err <= METRIC_M_TOL):
        failures.append(f"timing metric P {p_err} / M {m_err}")

    # matmul-form BP against the gather-form decoder in float64 on the host
    code = ldpc.build_ldpc(alist_mod.load_alist(FEC_ALIST))
    msg = rng.randint(0, 2, (codewords, code["K"]))
    cw = np.concatenate([(msg @ code["A"].T.astype(np.int64)) % 2, msg], 1)
    sigma = 0.7  # BPSK at Eb/N0 ~ 3 dB: most converge, in several iters
    y = (1.0 - 2.0 * cw) + sigma * rng.randn(*cw.shape)
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    hard, iters, ok = jax.device_get(jax.jit(
        lambda v: ldpc.decode_mm(v, code))(llr))
    with jax.default_device(jax.devices("cpu")[0]), jax.enable_x64(True):
        h_ref, it_ref, ok_ref = jax.device_get(jax.jit(
            lambda v: ldpc.decode(v, code))(llr.astype(np.float64)))
    both = ok & ok_ref
    same_bits = bool((hard[both] == h_ref[both]).all())
    it_diff = int(np.max(np.abs(iters[both] - it_ref[both]), initial=0))
    out["decode_mm"] = {"codewords": codewords,
                        "precision": ldpc.BP_PRECISION.name,
                        "converged": int(ok.sum()),
                        "converged_ref": int(ok_ref.sum()),
                        "hard_equal_on_converged": same_bits,
                        "max_iter_diff": it_diff, "iter_tol": 1}
    if not (same_bits and it_diff <= 1 and both.sum() > codewords // 2):
        failures.append(f"decode_mm: {out['decode_mm']}")

    # uncoded BER parity on the card
    ber = []
    for cnst_id, snr_db, n in (ber_points or PARITY_POINTS):
        pt = run_point(cnst_id, snr_db, n, seed=int(10 * snr_db) + cnst_id,
                       frame_length=10)
        ber.append({"cnst": cnst_id, "snr_db": snr_db, "ber": pt["ber"],
                    "loss_db": pt["loss_db"], "max_loss_db": MAX_LOSS_DB})
        if not (pt["ber"] > 0 and pt["loss_db"] is not None
                and pt["loss_db"] <= MAX_LOSS_DB):
            failures.append(f"BER parity cnst={cnst_id} @ {snr_db} dB: {pt}")
    out["ber_parity"] = ber
    out["failures"] = failures
    assert not failures, failures
    return out


def phase_four_cards(streams: int = 64, frames_per_block: int = 16,
                     blocks: int = 3, frame_length: int = 20,
                     meshes=((4, 1), (2, 2)), workdir: str | None = None):
    import jax

    from gr_dtl_jax.models import session
    from gr_dtl_jax.utils import config as cfgmod

    n_dev = max(s * t for s, t in meshes)
    assert len(jax.devices()) >= n_dev, (
        f"needs {n_dev} devices, JAX sees {len(jax.devices())}")
    common = ["--streams", str(streams), "--frames-per-block",
              str(frames_per_block), "--max-blocks", str(blocks),
              "--frame-length", str(frame_length), "--json"]
    rm, args = _modem(["stream-sharded", "--selftest"] + common)
    D = frames_per_block * cfgmod.make_rx_config(
        None, frame_length=frame_length).frame_samples
    chunks, payloads = rm.selftest_streams(args, D)
    n_chunks = chunks.shape[1] // D
    src = os.path.join(workdir, "sharded.c64")
    with open(src, "wb") as f:  # stream-major per dispatch chunk
        for c in range(n_chunks):
            chunks[:, c * D: (c + 1) * D].tofile(f)

    # reference: one StreamRx per stream, on one card
    rx = session.StreamRx(cfgmod.make_rx_config(
        None, frame_length=frame_length), frames_per_block=frames_per_block)
    ref = []
    for s in range(streams):
        rx.reset()
        dec = {}
        for c in range(n_chunks):
            out, valid = rx.process(chunks[s, c * D: (c + 1) * D])
            pay, lens = np.asarray(out.payload), np.asarray(out.payload_len)
            nos = np.asarray(out.frame_no)
            for i in np.nonzero(valid & valid.crc_ok)[0]:
                dec[int(nos[i])] = pay[i, : lens[i]].tobytes()
        ref.append(dec)
    for s, (pay, plen) in enumerate(payloads):
        want = {i: pay[i, : plen[i]].tobytes() for i in range(len(plen))}
        assert ref[s] == want, f"StreamRx stream {s} misses frames"

    results = []
    for n_s, n_t in meshes:
        _, args = _modem(["stream-sharded", "--source", f"file:{src}",
                          "--mesh-stream", str(n_s), "--mesh-time", str(n_t)]
                         + common)
        res, decoded, _ = rm.stream_sharded(args)
        for s in range(streams):
            assert decoded[s] == ref[s], (
                f"mesh {n_s}x{n_t}: stream {s} differs from StreamRx")
        used = {dev for dev, _, _ in res["shards"]}
        assert len(used) == n_s * n_t, f"shards on {sorted(used)} only"
        results.append({"mesh": [n_s, n_t], "streams": streams,
                        "blocks": n_chunks, "shards": res["shards"],
                        "frames_crc_ok": res["frames_crc_ok"],
                        "equal_to_stream_rx": True,
                        "compile_s": res["first_chunk_s"],
                        "step_ms": res["chunk_ms_median"]})
    return results


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card sharded session (phase f)")
    args = p.parse_args(argv)

    import jax

    from gr_dtl_jax.utils.compile_cache import enable_compile_cache
    from gr_dtl_jax.utils.platform import card_info, device_summary

    dev = device_summary()
    print(json.dumps({"phase": "device", **dev}), flush=True)
    if dev["platform"] != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev['platform']!r}",
              file=sys.stderr)
        return 2
    card = card_info()
    print(card, flush=True)
    enable_compile_cache()
    context = {"device_kind": dev["kind"], "card": card}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four_cards:
            if dev["count"] < 4:
                print(f"chip_smoke: --four-cards needs 4 GPUs, found "
                      f"{dev['count']}", file=sys.stderr)
                return 2
            for r in phase_four_cards(workdir=workdir):
                _emit("four_cards", r, context)
        else:
            _emit("reference", phase_reference(), context)
            _emit("batch", phase_batch(), context)
            _emit("coded", phase_coded(), context)
            for r in phase_stream(workdir):
                _emit("stream", r, context)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
