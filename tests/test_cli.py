"""App-layer smoke tests: the CLI tools run end to end as subprocesses
(the reference's grc_run-launched example flowgraphs, SURVEY.md #45-49)."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args):
    res = subprocess.run([sys.executable] + args, capture_output=True,
                         text=True, cwd=HERE, timeout=420)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


@pytest.mark.slow
def test_loopback_cli_with_overrides_and_ber(tmp_path):
    tx = tmp_path / "tx.dat"
    rx = tmp_path / "rx.dat"
    out = _run([
        "tools/run_modem.py", "loopback", "--frames", "8",
        "--frame-length", "10", "--snr-db", "25", "--cfo", "0.25",
        "--set", "cp_len=16", "--json",
        "--store-tx", str(tx), "--store-rx", str(rx),
    ])
    res = json.loads(out.strip().splitlines()[-1])
    assert res["crc_ok_rate"] == 1.0
    # offline scorer on the byte-compatible stores
    ber_out = _run(["tools/ber.py", str(tx), str(rx)])
    assert "ber" in ber_out.lower()


@pytest.mark.slow
def test_full_duplex_cli(tmp_path):
    out = _run([
        "tools/run_modem.py", "full-duplex", "--rounds", "12",
        "--frame-length", "10", "--snr-db", "30", "--snr-db-reverse", "6",
        "--json",
    ])
    res = json.loads(out.strip().splitlines()[-1])
    assert res["a_tx_cnst_final"] >= 1
    assert res["b_crc_rate"] > 0.5


def test_replay_cli_with_sdr_profile(tmp_path):
    """BASELINE config 4 at the app layer: synthesize a capture with CFO
    + noise + a leading pad, write raw complex64, and drive
    tools/replay.py with the SDR profile (the reference's Pluto
    workflow, examples/ofdm_adaptive_pluto.json analogue)."""
    import numpy as np

    gen = os.path.join(HERE, "tools", "_gen_capture_for_test.py")
    cap = tmp_path / "capture.c64"
    # generate the capture in a subprocess so this test stays a pure
    # CLI-level check (and the CPU platform pin in the tools applies)
    script = f"""
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp
from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.models import transmitter
from gr_dtl_jax.ops import channel

txcfg = cfgmod.make_tx_config("examples/ofdm_adaptive_sdr.json", frame_length=10)
txp = transmitter.build_tx(txcfg)
B = 6
rng = np.random.RandomState(11)
maxb = txcfg.max_frame_bytes()
payload = np.zeros((B, maxb), np.uint8)
plen = np.full((B,), txcfg.frame_bytes(2) - 4, np.int32)
for i in range(B):
    payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
out = transmitter.tx_frames(txp, jnp.asarray(payload), jnp.asarray(plen),
    jnp.full((B,), 2, jnp.int32), jnp.zeros(B, jnp.int32),
    jnp.arange(B, dtype=jnp.int32), jax.random.PRNGKey(3))
stream = np.asarray(out.samples).reshape(-1)
# oscillator offset + timing offset + noise, like a real capture
n = np.arange(len(stream))
stream = stream * np.exp(2j * np.pi * 0.2 / txcfg.fft_len * n)
stream = np.concatenate([np.zeros(37, np.complex64), stream])
rng2 = np.random.RandomState(12)
stream = stream + 0.01 * (rng2.randn(len(stream)) + 1j * rng2.randn(len(stream))) / np.sqrt(2)
stream.astype(np.complex64).tofile({str(cap)!r})
"""
    subprocess.run([sys.executable, "-c", script], check=True, cwd=HERE,
                   timeout=420)
    out = _run([
        "tools/replay.py", str(cap), "--frames", "5",
        "--frame-length", "10",
        "--config", "examples/ofdm_adaptive_sdr.json", "--json",
    ])
    res = json.loads(out.strip().splitlines()[-1])
    assert res["header_ok_rate"] == 1.0
    assert res["crc_ok_rate"] == 1.0
    assert abs(res["mean_cfo_subcarriers"] - 0.2) < 0.05


def test_run_modem_needs_a_gpu_unless_told_cpu():
    """Without --cpu / RUN_MODEM_CPU=1 a missing GPU is an error, never a
    quiet run on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "RUN_MODEM_CPU"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, "tools/run_modem.py", "loopback", "--frames", "4",
         "--frame-length", "4", "--json"],
        capture_output=True, text=True, cwd=HERE, timeout=300, env=env)
    assert res.returncode != 0
    assert "no GPU found" in res.stderr
    assert res.stdout.strip() == ""


@pytest.mark.gpu
def test_loopback_cli_on_gpu():
    """The flagship CLI demo on a GPU (tools need one unless `--cpu`)."""
    env = dict(os.environ)
    env.pop("RUN_MODEM_CPU", None)  # conftest pins subprocesses to CPU
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "tools/run_modem.py", "loopback", "--frames", "8",
         "--frame-length", "10", "--snr-db", "25", "--json"],
        capture_output=True, text=True, cwd=HERE, timeout=420, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["crc_ok_rate"] == 1.0


@pytest.mark.gpu
def test_stream_daemon_on_gpu(tmp_path):
    """The always-on RX daemon's host loop on a GPU: per-block H2D,
    carried lock state, one packed accounting readback per block."""
    cap = tmp_path / "capture.c64"
    subprocess.run(  # capture generated on the CPU (the TX daemon)
        [sys.executable, "tools/run_modem.py", "stream-tx", "--sink",
         f"file:{cap}", "--frame-length", "10", "--frames-per-block",
         "4", "--pdus", "8", "--pdu-bytes", "30", "--max-blocks", "2",
         "--json"],
        check=True, capture_output=True, cwd=HERE, timeout=420,
        env={**os.environ, "RUN_MODEM_CPU": "1"})
    env = dict(os.environ)
    env.pop("RUN_MODEM_CPU", None)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "tools/run_modem.py", "stream", "--source",
         f"file:{cap}", "--frame-length", "10", "--frames-per-block",
         "4", "--json"],
        capture_output=True, text=True, cwd=HERE, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["frames_crc_ok"] >= 4
    assert out["frames_crc_ok"] == out["frames_header_ok"]


@pytest.mark.slow
def test_stream_daemon_cli(tmp_path):
    """The always-on RX daemon over a file source: decodes a capture,
    writes a scoreable frame store, pipelined readback gives identical
    counts (run_modem stream — the deployment entry point)."""
    import numpy as np

    cap = tmp_path / "capture.c64"
    script = f"""
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp
from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.models import transmitter
from gr_dtl_jax.ops import channel, constellation as cn

txcfg = cfgmod.make_tx_config(None, frame_length=10)
txp = transmitter.build_tx(txcfg)
B = 8
rng = np.random.RandomState(5)
maxb = txcfg.max_frame_bytes()
cnst = rng.randint(1, 5, B).astype(np.int32)
payload = np.zeros((B, maxb), np.uint8)
plen = np.zeros(B, np.int32)
for i in range(B):
    plen[i] = txcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst[i]])) - 4
    payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
out = transmitter.tx_frames(txp, jnp.asarray(payload), jnp.asarray(plen),
    jnp.asarray(cnst), jnp.zeros(B, jnp.int32),
    jnp.arange(B, dtype=jnp.int32), jax.random.PRNGKey(3))
stream = np.asarray(out.samples).reshape(-1)
stream = np.concatenate([np.zeros(101, np.complex64), stream])
rng2 = np.random.RandomState(12)
stream = stream + 0.01 * (rng2.randn(len(stream)) + 1j * rng2.randn(len(stream))) / np.sqrt(2)
stream.astype(np.complex64).tofile({str(cap)!r})
"""
    subprocess.run([sys.executable, "-c", script], check=True, cwd=HERE,
                   timeout=420)
    rx_store = tmp_path / "rx.dat"
    out = _run([
        "tools/run_modem.py", "stream", "--source", f"file:{cap}",
        "--frame-length", "10", "--frames-per-block", "4", "--json",
        "--store-rx", str(rx_store),
    ])
    res = json.loads(out.strip().splitlines()[-1])
    assert res["frames_crc_ok"] == 8
    assert rx_store.stat().st_size > 0

    out2 = _run([
        "tools/run_modem.py", "stream", "--source", f"file:{cap}",
        "--frame-length", "10", "--frames-per-block", "4", "--json",
        "--pipeline-depth", "3",
    ])
    res2 = json.loads(out2.strip().splitlines()[-1])
    assert res2["frames_crc_ok"] == 8
    assert res2["blocks"] == res["blocks"]


@pytest.mark.slow
def test_stream_tx_rx_cli_link():
    """Two-process CLI link: `stream` listens for samples on TCP,
    `stream-tx` connects and transmits — frames decode CRC-clean over
    the real socket (the reference's TX/RX flowgraph pair under
    grc_run)."""
    import socket
    import time

    # pick a free port
    s = socket.socket(); s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]; s.close()

    rx = subprocess.Popen(
        [sys.executable, "tools/run_modem.py", "stream",
         "--source", f"listen:{port}", "--frame-length", "10",
         "--frames-per-block", "4", "--json"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE)
    # no fixed sleep needed: sample_io.connect retries with backoff
    # until the RX daemon (which imports jax before binding) is up
    time.sleep(0.5)
    tx_out = _run([
        "tools/run_modem.py", "stream-tx", "--sink",
        f"tcp:127.0.0.1:{port}", "--frame-length", "10",
        "--frames-per-block", "4", "--pdus", "12", "--pdu-bytes", "30",
        "--max-blocks", "6", "--json",
    ])
    tx_res = json.loads(tx_out.strip().splitlines()[-1])
    assert tx_res["payload_frames"] == 12
    out, err = rx.communicate(timeout=300)
    assert rx.returncode == 0, err[-2000:]
    rx_res = json.loads(out.strip().splitlines()[-1])
    assert rx_res["blocks"] == 6
    # every fully-contained frame decodes; the final frame may straddle
    # the EOF boundary
    assert rx_res["frames_crc_ok"] >= 20
    assert rx_res["frames_crc_ok"] == rx_res["frames_header_ok"]


def test_stream_sharded_selftest():
    """The sharded daemon CLI decodes its own multi-stream input
    CRC-clean on the virtual mesh (megastep included)."""
    stdout = _run(["tools/run_modem.py", "stream-sharded", "--selftest",
                   "--streams", "2", "--mesh-stream", "2",
                   "--mesh-time", "4", "--frames-per-block", "8",
                   "--blocks-per-dispatch", "2", "--frame-length", "10",
                   "--json"])
    out = json.loads(stdout.strip().splitlines()[-1])
    assert out["selftest_pass"] is True
    assert out["frames_crc_ok"] == out["frames_header_ok"] > 0
