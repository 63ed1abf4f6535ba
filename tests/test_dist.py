"""Multi-host layout helpers: host-aware (stream, time) mesh keeps halo
rings within one host; init() is a single-process no-op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.parallel import dist, stream as pstream
from gr_dtl_jax.utils import config as cfgmod


def test_init_noop_single_process(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR", raising=False)
    assert dist.init() is False


def test_host_mesh_layout_and_step():
    assert jax.device_count() >= 8
    m = dist.make_host_mesh(n_time=2)
    assert m.shape == {"stream": jax.device_count() // 2, "time": 2}
    # every time ring must stay within one process's devices
    dev = np.array(m.devices)
    for row in dev:
        assert len({d.process_index for d in row}) == 1

    txcfg = cfgmod.make_tx_config(None, frame_length=4)
    rxcfg = cfgmod.make_rx_config(None, frame_length=4)
    rng = np.random.RandomState(0)
    S, Fs = dev.shape[0], 2
    maxb = txcfg.max_frame_bytes()
    plen = np.full((S, Fs), txcfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((S, Fs, maxb), np.uint8)
    for s in range(S):
        for f in range(Fs):
            payload[s, f, : plen[s, f]] = rng.randint(0, 256, plen[s, f])
    step, _ = pstream.build_sharded_loopback(
        txcfg, rxcfg, m, frames_per_block=1, noise_v=0.01)
    out = step(jnp.asarray(payload), jnp.asarray(plen),
               jnp.full((S, Fs), 2, jnp.int32),
               jnp.tile(np.arange(Fs, dtype=np.int32), (S, 1)),
               jax.random.PRNGKey(0))
    assert np.asarray(out.crc_ok).all()


def test_host_mesh_rejects_ring_across_hosts():
    with pytest.raises(ValueError):
        dist.make_host_mesh(n_time=3)  # does not divide 8


@pytest.mark.slow
def test_two_process_distributed():
    """Real 2-process jax.distributed run: spawns
    two OS processes with 4 virtual CPU devices each, gloo collectives,
    and requires byte-exact decode through the global (stream, time)
    mesh in both processes."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    # workers set their own platform/device env; scrub the test env
    env.pop("JAX_COORDINATOR", None)
    r = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "multihost.py"),
         "--launch"],
        capture_output=True, text=True, timeout=800, cwd=root, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    data = json.loads(r.stdout)
    assert data["n_processes"] == 2
    assert data["crc_ok_all"] is True
    assert all(w["global_devices"] == 8 and w["local_devices"] == 4
               for w in data["workers"])


@pytest.mark.slow
def test_two_process_sharded_session():
    """REAL 2-process continuous sharded streaming session: carried
    tail/lock/accounting state chained across process() calls on a
    global jax.distributed mesh, 3 blocks, byte-exact in both
    processes (the always-on multi-host mode)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("JAX_COORDINATOR", None)
    r = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "multihost.py"),
         "--session", "--streams", "4", "--frames-per-block", "8",
         "--n-time", "2", "--frame-length", "10"],
        capture_output=True, text=True, timeout=1000, cwd=root, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    data = json.loads(r.stdout)
    assert data["n_processes"] == 2
    assert data["byte_exact_all"] is True
    assert all(w["chained_blocks"] == 3 and w["lost_frames"] == 0
               for w in data["workers"])
