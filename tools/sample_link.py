#!/usr/bin/env python3
"""Two-process modem link over a real byte stream (TCP samples).

The live-I/O counterpart of the reference's Pluto examples
(``/root/reference/examples/ofdm_adaptive_pluto_tx.grc``,
``examples/ofdm_adaptive_pluto.json:2-5``): two OS processes exchange
complex64 samples over a duplex TCP connection — forward OFDM frames
one way, the reverse feedback-burst capture the other — through the
``testbed/sample_io.py`` source/sink boundary that a real SDR front-end
would plug into.

  TX node:  StreamTx --> sink  |  source --> StreamBurstRx --> MCS switch
  RX node:  source --> (AWGN) --> StreamRx --> MCS decision --> burst --> sink

The protocol is strictly alternating per block (TX: write fwd, read
rev; RX: read fwd, write rev), so the link is deadlock-free for any
block size.  AWGN is injected host-side at the RX (the "RF channel" of
this wired setup); the adaptation loop must climb the MCS ladder from
BPSK to whatever the configured SNR supports, via real decoded feedback
bursts flowing back over the socket.

Full-duplex mode (--duplex-a / --duplex-b): each node runs a
``StreamTx`` AND a ``StreamRx`` — OFDM frames flow BOTH ways over the
same socket and adaptation is **in-band** via the header echo (the
reference's ``ofdm_adaptive_full_duplex.py:29-43`` deployed as two OS
processes instead of one in-process session): each node's RX SNR drives
its MCS decision, which rides its *outgoing* headers as
``feedback_constellation`` and, decoded by the peer, switches the
peer's TX constellation.  The protocol is strictly alternating per
block (A: write fwd, read rev; B: read fwd, write rev), deadlock-free
for equal block sizes.

Modes:
  --tx / --rx        one simplex node (connect/listen per --port/--host)
  --duplex-a / --duplex-b   one full-duplex node (a connects, b listens)
  --loopback-test    spawn both simplex nodes as subprocesses on
                     localhost, collect their JSON reports, assert
                     CRC-clean decode + adaptation convergence, --out
  --duplex-test      same for the full-duplex pair (both directions
                     CRC-clean, both adaptation loops converged)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def _node_platform(on_gpu: bool = False):
    """Nodes run on the CPU; ``--gpu`` gives the card to the RX node
    alone (one JAX process per card: a second one would find the card's
    memory already reserved)."""
    from gr_dtl_jax.utils.platform import select_platform

    select_platform(force_cpu=not on_gpu, tool="sample_link")


def tx_node(args):
    _node_platform()
    import jax  # noqa: F401  (platform pinned above)
    from gr_dtl_jax.models import session
    from gr_dtl_jax.testbed import sample_io
    from gr_dtl_jax.utils import config as cfgmod

    cfg = cfgmod.make_tx_config(
        args.config, frame_length=args.frame_length,
        max_empty_frames=2 * args.frames_per_block)
    tx = session.StreamTx(cfg, frames_per_block=args.frames_per_block)
    brx = session.StreamBurstRx(args.rev_block)

    rng = np.random.RandomState(args.seed)
    for _ in range(args.pdus):
        tx.send(rng.randint(0, 256, args.pdu_bytes).astype(np.uint8).tobytes())

    ep = sample_io.connect(args.host, args.port, timeout=120.0)
    blocks = 0
    fb_applied = []
    try:
        while True:
            blk = tx.next_block()
            if blk is None:
                break
            samples, _info = blk
            ep.sink.write(samples)
            rev = ep.source.read(args.rev_block)
            if len(rev) < args.rev_block:
                break  # peer hung up
            bout = brx.process(rev)
            okb = np.asarray(bout.ok)
            if okb.any():
                i = int(np.nonzero(okb)[0][-1])
                cnst = int(np.asarray(bout.cnst_id)[i])
                tx.set_feedback(cnst)
                fb_applied.append(cnst)
            blocks += 1
    finally:
        ep.close()
    print("TX_RESULT " + json.dumps({
        "blocks": blocks,
        "samples_sent": int(ep.sink.n_written),
        "pdus": args.pdus,
        "feedback_applied": fb_applied,
        "final_cnst": tx.constellation,
    }), flush=True)


def rx_node(args):
    _node_platform(args.gpu)
    import jax
    import jax.numpy as jnp
    from gr_dtl_jax.models import adaptive, session
    from gr_dtl_jax.ops import burst
    from gr_dtl_jax.testbed import sample_io
    from gr_dtl_jax.utils import config as cfgmod

    rxcfg = cfgmod.make_rx_config(args.config, frame_length=args.frame_length)
    rx = session.StreamRx(rxcfg, frames_per_block=args.frames_per_block)
    tables = adaptive.build_mcs_tables(rxcfg)
    fb_state = adaptive.initial_state(rxcfg.initial_mcs_id)
    cnst_of_mcs = np.asarray(tables["cnst"])
    fec_of_mcs = np.asarray(tables["fec"])
    modem = burst.build_burst_modem()
    burst_fn = jax.jit(lambda c, f: burst.burst_tx(c, f, modem, pad=0))

    @jax.jit
    def fb_scan(state, snrs, mask):
        def stepf(s, x):
            snr, m = x
            ns, mcs = adaptive.feedback_step(s, snr, tables)
            ns = jax.tree.map(lambda a, b: jnp.where(m, a, b), ns, s)
            return ns, jnp.where(m, mcs, s.last)

        return jax.lax.scan(stepf, state, (snrs, mask))

    srv, port = sample_io.listen(args.host, args.port)
    print(f"RX_LISTENING {port}", flush=True)
    ep = sample_io.accept_endpoint(srv, timeout=120.0)
    srv.close()

    rng = np.random.RandomState(args.seed + 1)
    noise_v = 0.0
    if args.snr_db is not None:
        # signal power of the modulated stream is ~0.81 (pilot+data mix)
        noise_v = float(np.sqrt(0.81 / 10 ** (args.snr_db / 10)))

    n_ok = n_crc = n_frames = n_payload = 0
    want_hist = []
    try:
        while True:
            chunk = ep.source.read(rx.block_samples)
            if len(chunk) < rx.block_samples:
                break  # EOF: TX finished
            if noise_v > 0:
                chunk = chunk + (noise_v / np.sqrt(2)) * (
                    rng.standard_normal(len(chunk))
                    + 1j * rng.standard_normal(len(chunk))
                ).astype(np.complex64)
            out, valid = rx.process(chunk)
            ok = valid.header_ok & valid
            n_frames += int(valid.sum())
            n_ok += int(ok.sum())
            # CRC gate only counts frames that carry payload (empty
            # keepalive frames have no CRC to pass)
            has_payload = np.asarray(out.payload_len) > 0
            n_payload += int((ok & has_payload).sum())
            n_crc += int((valid.crc_ok & ok & has_payload).sum())

            rev = np.zeros(args.rev_block, np.complex64)
            if ok.any():
                fb_state, mcs_seq = fb_scan(
                    fb_state, out.snr_db, jnp.asarray(ok))
                mcs = int(np.asarray(mcs_seq)[np.nonzero(ok)[0][-1]])
                want = int(cnst_of_mcs[mcs])
                want_hist.append(want)
                wave = np.asarray(burst_fn(
                    jnp.asarray([want], jnp.int32),
                    jnp.asarray([int(fec_of_mcs[mcs])], jnp.int32)))[0]
                off = rng.randint(0, args.rev_block - len(wave))
                rev[off: off + len(wave)] = wave
            ep.sink.write(rev)
    finally:
        ep.close()
    print("RX_RESULT " + json.dumps({
        "frames": n_frames,
        "header_ok": n_ok,
        "payload_frames": n_payload,
        "payload_crc_ok": n_crc,
        "lost_frame_rate": rx.lost_frame_rate,
        "want_final": want_hist[-1] if want_hist else None,
        "want_hist": want_hist[:64],
        "samples_received": int(ep.source.n_read),
    }), flush=True)


def duplex_node(args, initiator: bool):
    """One full-duplex node: StreamTx + StreamRx over one socket,
    in-band echo adaptation (ref ofdm_adaptive_full_duplex.py:29-43 as
    a deployed two-process system)."""
    _node_platform()
    import jax
    import jax.numpy as jnp
    from gr_dtl_jax.models import adaptive, session
    from gr_dtl_jax.testbed import sample_io
    from gr_dtl_jax.utils import config as cfgmod

    role = "a" if initiator else "b"
    txcfg = cfgmod.make_tx_config(
        args.config, frame_length=args.frame_length,
        max_empty_frames=4 * args.frames_per_block)
    rxcfg = cfgmod.make_rx_config(args.config,
                                  frame_length=args.frame_length)
    tx = session.StreamTx(txcfg, frames_per_block=args.frames_per_block)
    rx = session.StreamRx(rxcfg, frames_per_block=args.frames_per_block)
    tables = adaptive.build_mcs_tables(rxcfg)
    fb_state = adaptive.initial_state(rxcfg.initial_mcs_id)
    cnst_of_mcs = np.asarray(tables["cnst"])

    @jax.jit
    def fb_scan(state, snrs, mask):
        def stepf(s, x):
            snr, m = x
            ns, mcs = adaptive.feedback_step(s, snr, tables)
            ns = jax.tree.map(lambda a, b: jnp.where(m, a, b), ns, s)
            return ns, jnp.where(m, mcs, s.last)

        return jax.lax.scan(stepf, state, (snrs, mask))

    rng = np.random.RandomState(args.seed + (0 if initiator else 1))
    for _ in range(args.pdus):
        tx.send(rng.randint(0, 256, args.pdu_bytes).astype(np.uint8)
                .tobytes())

    if initiator:
        ep = sample_io.connect(args.host, args.port, timeout=120.0)
    else:
        srv, port = sample_io.listen(args.host, args.port)
        print(f"RX_LISTENING {port}", flush=True)
        ep = sample_io.accept_endpoint(srv, timeout=120.0)
        srv.close()

    noise_v = 0.0
    if args.snr_db is not None:
        noise_v = float(np.sqrt(0.81 / 10 ** (args.snr_db / 10)))

    n_frames = n_ok = n_payload = n_crc = 0
    blocks = 0
    want_hist = []  # local decisions about the INCOMING link
    applied_hist = []  # peer echoes applied to the OUTGOING link
    try:
        while True:
            if initiator:
                blk = tx.next_block()
                if blk is None:
                    break
                ep.sink.write(blk[0])
                chunk = ep.source.read(rx.block_samples)
                if len(chunk) < rx.block_samples:
                    break
            else:
                chunk = ep.source.read(rx.block_samples)
                if len(chunk) < rx.block_samples:
                    break
                blk = tx.next_block()
                if blk is None:
                    break
                ep.sink.write(blk[0])
            blocks += 1
            if noise_v > 0:
                chunk = chunk + (noise_v / np.sqrt(2)) * (
                    rng.standard_normal(len(chunk))
                    + 1j * rng.standard_normal(len(chunk))
                ).astype(np.complex64)
            out, valid = rx.process(chunk)
            ok = valid.header_ok & valid
            n_frames += int(valid.sum())
            n_ok += int(ok.sum())
            has_payload = np.asarray(out.payload_len) > 0
            n_payload += int((ok & has_payload).sum())
            n_crc += int((valid.crc_ok & ok & has_payload).sum())
            if ok.any():
                # local decision -> echo in OUR headers (peer will
                # switch); peer's echo in THEIR headers -> our TX MCS
                fb_state, mcs_seq = fb_scan(fb_state, out.snr_db,
                                            jnp.asarray(ok))
                mcs = int(np.asarray(mcs_seq)[np.nonzero(ok)[0][-1]])
                want = int(cnst_of_mcs[mcs])
                want_hist.append(want)
                tx.set_feedback_echo(want)
                echoes = np.asarray(out.feedback_cnst)[ok]
                echoes = echoes[echoes > 0]
                if echoes.size:
                    applied = int(echoes[-1])
                    tx.set_feedback(applied)
                    applied_hist.append(applied)
    finally:
        ep.close()
    print(f"DPX_{role.upper()}_RESULT " + json.dumps({
        "role": role,
        "blocks": blocks,
        "frames": n_frames,
        "header_ok": n_ok,
        "payload_frames": n_payload,
        "payload_crc_ok": n_crc,
        "lost_frame_rate": rx.lost_frame_rate,
        "final_tx_cnst": tx.constellation,
        "want_final": want_hist[-1] if want_hist else None,
        "want_hist": want_hist[:64],
        "applied_hist": applied_hist[:64],
        "samples_sent": int(ep.sink.n_written),
        "samples_received": int(ep.source.n_read),
    }), flush=True)


def duplex_test(args):
    """Spawn two full-duplex nodes; assert both directions decode
    CRC-clean and both in-band adaptation loops converged."""
    import socket as _socket

    with _socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["RUN_MODEM_CPU"] = "1"
    base = [sys.executable, os.path.abspath(__file__),
            "--port", str(port),
            "--frames-per-block", str(args.frames_per_block),
            "--frame-length", str(args.frame_length),
            "--pdus", str(args.pdus),
            "--pdu-bytes", str(args.pdu_bytes),
            "--seed", str(args.seed)]
    if args.config:
        base += ["--config", args.config]
    if args.snr_db is not None:
        base += ["--snr-db", str(args.snr_db)]
    bp = subprocess.Popen(base + ["--duplex-b"], env=env,
                          stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    for line in bp.stdout:
        if line.startswith("RX_LISTENING"):
            break
    ap_ = subprocess.Popen(base + ["--duplex-a"], env=env,
                           stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    a_out = ap_.communicate(timeout=1200)[0]
    b_out = bp.communicate(timeout=300)[0]
    if ap_.returncode != 0 or bp.returncode != 0:
        sys.stderr.write(f"--- a ---\n{a_out}\n--- b ---\n{b_out}\n")
        raise SystemExit("duplex node process failed")
    a = json.loads([l for l in a_out.splitlines()
                    if l.startswith("DPX_A_RESULT ")][-1][13:])
    b = json.loads([l for l in b_out.splitlines()
                    if l.startswith("DPX_B_RESULT ")][-1][13:])
    result = {
        "transport": "tcp sample stream (complex64), OFDM both ways, "
                     "in-band echo adaptation",
        "port": port,
        "a": a,
        "b": b,
        # each node's TX ends on the constellation the PEER decided for
        # that link (peer's want == our final TX MCS)
        "adaptation_converged_ab": (b["want_final"] is not None
                                    and a["final_tx_cnst"]
                                    == b["want_final"]),
        "adaptation_converged_ba": (a["want_final"] is not None
                                    and b["final_tx_cnst"]
                                    == a["want_final"]),
        "crc_clean_ab": (b["payload_frames"] > 0
                         and b["payload_crc_ok"] == b["payload_frames"]),
        "crc_clean_ba": (a["payload_frames"] > 0
                         and a["payload_crc_ok"] == a["payload_frames"]),
    }
    print(json.dumps(result, indent=2))
    assert result["crc_clean_ab"], "A->B payload CRC failures"
    assert result["crc_clean_ba"], "B->A payload CRC failures"
    assert result["adaptation_converged_ab"], "A->B adaptation diverged"
    assert result["adaptation_converged_ba"], "B->A adaptation diverged"
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)


def loopback_test(args):
    """Spawn RX (listener) + TX (connector) subprocesses on localhost and
    assert the link: CRC-clean payload decode and MCS convergence."""
    import socket as _socket

    with _socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["RUN_MODEM_CPU"] = "1"
    base = [sys.executable, os.path.abspath(__file__),
            "--port", str(port),
            "--frames-per-block", str(args.frames_per_block),
            "--frame-length", str(args.frame_length),
            "--pdus", str(args.pdus),
            "--pdu-bytes", str(args.pdu_bytes),
            "--seed", str(args.seed)]
    if args.config:
        base += ["--config", args.config]
    rx_env = env
    if args.gpu:
        rx_env = {k: v for k, v in env.items() if k != "RUN_MODEM_CPU"}
    rxp = subprocess.Popen(base + ["--rx"] + (
        ["--snr-db", str(args.snr_db)] if args.snr_db is not None else [])
        + (["--gpu"] if args.gpu else []),
        env=rx_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    # wait for the listener before connecting
    for line in rxp.stdout:
        if line.startswith("RX_LISTENING"):
            break
    txp = subprocess.Popen(base + ["--tx"], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    tx_out = txp.communicate(timeout=1200)[0]
    rx_rest = rxp.communicate(timeout=300)[0]
    if txp.returncode != 0 or rxp.returncode != 0:
        sys.stderr.write(f"--- tx ---\n{tx_out}\n--- rx ---\n{rx_rest}\n")
        raise SystemExit("node process failed")
    tx = json.loads([l for l in tx_out.splitlines()
                     if l.startswith("TX_RESULT ")][-1][10:])
    rx = json.loads([l for l in rx_rest.splitlines()
                     if l.startswith("RX_RESULT ")][-1][10:])
    result = {
        "transport": "tcp sample stream (complex64), duplex",
        "port": port,
        "tx": tx,
        "rx": rx,
        "adaptation_converged": (rx["want_final"] == tx["final_cnst"]
                                 and tx["final_cnst"] is not None),
        "crc_clean": (rx["payload_frames"] > 0
                      and rx["payload_crc_ok"] == rx["payload_frames"]),
    }
    print(json.dumps(result, indent=2))
    assert result["crc_clean"], "payload CRC failures over the link"
    assert tx["blocks"] > 0 and rx["frames"] > 0
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tx", action="store_true")
    ap.add_argument("--rx", action="store_true")
    ap.add_argument("--duplex-a", action="store_true")
    ap.add_argument("--duplex-b", action="store_true")
    ap.add_argument("--loopback-test", action="store_true")
    ap.add_argument("--duplex-test", action="store_true")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5660)
    ap.add_argument("--config", default=None)
    ap.add_argument("--frames-per-block", type=int, default=8)
    ap.add_argument("--frame-length", type=int, default=10)
    ap.add_argument("--rev-block", type=int, default=4096)
    ap.add_argument("--pdus", type=int, default=64)
    ap.add_argument("--pdu-bytes", type=int, default=40)
    ap.add_argument("--snr-db", type=float, default=None,
                    help="inject AWGN at the RX (default: clean wire)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--gpu", action="store_true",
                    help="loopback test: run the RX node on the GPU (the "
                         "TX node stays on the CPU)")
    args = ap.parse_args()
    if args.tx:
        tx_node(args)
    elif args.rx:
        rx_node(args)
    elif args.duplex_a:
        duplex_node(args, initiator=True)
    elif args.duplex_b:
        duplex_node(args, initiator=False)
    elif args.duplex_test:
        duplex_test(args)
    else:
        loopback_test(args)


if __name__ == "__main__":
    main()
