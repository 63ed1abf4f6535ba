"""Sample-I/O boundary tests: typed complex64 byte streams (the SDR
front-end seam — reference Pluto examples,
``examples/ofdm_adaptive_pluto.json:2-5``) and the two-process TCP
modem link built on them (tools/sample_link.py)."""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from gr_dtl_jax.testbed import sample_io

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_socket_roundtrip_and_eof():
    srv, port = sample_io.listen()
    got = {}

    def server():
        ep = sample_io.accept_endpoint(srv, timeout=10)
        got["x"] = ep.source.read(1000)
        ep.sink.write(got["x"] * 2)
        ep.close()

    t = threading.Thread(target=server)
    t.start()
    ep = sample_io.connect("127.0.0.1", port)
    x = (np.arange(1000) + 1j * np.arange(1000)).astype(np.complex64)
    ep.sink.write(x)
    y = ep.source.read(1000)
    t.join()
    assert np.array_equal(got["x"], x)
    assert np.array_equal(y, x * 2)
    # short read only at EOF, then sticky
    z = ep.source.read(10)
    assert len(z) == 0 and ep.source.eof
    assert ep.sink.n_written == 1000 and ep.source.n_read == 1000


def test_chunked_reads_any_boundary():
    """The wire is samples, not packets: arbitrary write chunking must
    reassemble exactly (incl. a torn mid-sample boundary)."""
    a, b = socket.socketpair()
    src = sample_io.SampleSource(a)
    x = np.arange(257, dtype=np.complex64) * (1 - 0.5j)
    raw = x.tobytes()
    # drip-feed in awkward chunk sizes crossing item boundaries
    def writer():
        i = 0
        for n in [3, 13, 1, 100, 7, 1024, len(raw)]:
            b.sendall(raw[i : i + n])
            i += n
            if i >= len(raw):
                break
        b.close()

    t = threading.Thread(target=writer)
    t.start()
    y1 = src.read(100)
    y2 = src.read(157)
    t.join()
    assert np.array_equal(np.concatenate([y1, y2]), x)
    assert len(src.read(5)) == 0  # EOF


def test_fifo_pair(tmp_path):
    path = str(tmp_path / "samples.fifo")
    x = np.exp(2j * np.pi * np.arange(500) / 50).astype(np.complex64)
    res = {}

    def reader():
        src = sample_io.fifo_source(path)
        res["y"] = src.read(500)
        src.close()

    t = threading.Thread(target=reader)
    t.start()
    sink = sample_io.fifo_sink(path)
    sink.write(x)
    sink.close()
    t.join()
    assert np.array_equal(res["y"], x)


@pytest.mark.slow
def test_two_process_tcp_link_adaptation():
    """BASELINE config-4-style live link: two OS processes, duplex TCP
    sample stream, AWGN at the RX, feedback bursts back over the wire;
    asserts CRC-clean payload and MCS convergence (the reference's
    Pluto TX/RX pair, minus the antennas)."""
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "tools", "sample_link.py"),
         "--loopback-test", "--pdus", "24", "--frames-per-block", "8",
         "--frame-length", "10", "--snr-db", "30"],
        capture_output=True, text=True, timeout=1200, cwd=HERE)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = json.loads(r.stdout[r.stdout.index("{"):])
    assert res["crc_clean"] is True
    assert res["adaptation_converged"] is True
    assert res["tx"]["final_cnst"] == 4  # climbed to QAM16 at 30 dB
    assert res["rx"]["samples_received"] == res["tx"]["samples_sent"]


@pytest.mark.slow
def test_two_process_full_duplex_link():
    """Full-duplex two-process link: OFDM frames BOTH ways over one
    socket, in-band header-echo adaptation both ways (the reference's
    ofdm_adaptive_full_duplex as a deployed two-process system).  Both
    directions must decode CRC-clean and both ladders converge."""
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "tools", "sample_link.py"),
         "--duplex-test", "--pdus", "24", "--pdu-bytes", "30",
         "--frames-per-block", "4", "--frame-length", "10",
         "--snr-db", "25", "--seed", "3"],
        capture_output=True, text=True, timeout=1200, cwd=HERE)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = json.loads(r.stdout[r.stdout.index("{"):])
    assert res["crc_clean_ab"] and res["crc_clean_ba"]
    assert res["adaptation_converged_ab"] and res["adaptation_converged_ba"]
    # at 25 dB both directions climb the ladder off BPSK
    assert res["a"]["final_tx_cnst"] >= 3
    assert res["b"]["final_tx_cnst"] >= 3
    # the wants climbed monotonically through the ladder
    for node in ("a", "b"):
        hist = res[node]["want_hist"]
        assert hist == sorted(hist)
