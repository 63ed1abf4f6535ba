#!/usr/bin/env python3
"""Real multi-process ``jax.distributed`` run of the sharded modem.

The reference has no distributed runtime (SURVEY.md §2f); this tool is
the evidence path for the multi-host target (BASELINE.md: >=85%
efficiency at 2 hosts): it launches N actual OS processes, each owning
a slice of a global ``(stream, time)`` device mesh, initializes
``jax.distributed`` against a local coordinator, runs the full
TX+channel+RX SPMD step (``parallel/stream.build_sharded_loopback``)
over globally-sharded arrays, asserts every frame decodes byte-exactly,
and measures per-step wall time *and per-process CPU time* (rusage), so
the artifact separates cross-process overhead from plain CPU
contention on small hosts.

Modes:
  --launch         spawn ``--procs`` worker subprocesses (CPU platform,
                   ``--devices-per-proc`` virtual devices each), plus
                   TWO single-process reference points of the SAME
                   per-device workload:
                     * strong base: 1 process, all devices, full global
                       workload (efficiency = no-cross-process-overhead)
                     * weak base: 1 process, one host's devices, one
                       host's share of the streams (efficiency = does
                       adding a host add proportional capacity)
                   and write a JSON artifact with both efficiencies.
  --worker         one distributed process (spawned by --launch).
  --baseline N     strong base worker (spawned by --launch).
  --baseline-half  weak base worker (spawned by --launch).

This tool runs on the CPU only: every process uses the CPU platform
with gloo collectives.  A multi-process launch on GPUs (one process per
card, NCCL collectives) is not written yet.  ``dist.init`` reads
JAX_COORDINATOR/JAX_NUM_PROCESSES/JAX_PROCESS_ID, and the mesh comes
out (hosts*devices // n_time, n_time) with each time ring inside one
host.

Workload sizing (learned in round 2): at 8 streams x 2 frames/block the
per-step wall time is ~all gloo dispatch latency and efficiency reads
~0.78; the artifact run uses 64 streams x 16 frames/block x 20 steps
(BASELINE config 5 scale) so per-step compute dominates dispatch.
Defaults here stay small to keep the CI test fast.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

# CI-fast defaults; the artifact run overrides via CLI (see module
# docstring).  Workers inherit the launcher's choices through the
# GR_DTL_MH_* env vars.
DEFAULTS = {
    "streams": 8,
    "frames_per_block": 2,
    "n_time": 2,
    "steps": 3,
    "frame_length": 4,
    "warmup": 1,
}


def _params():
    return {k: int(os.environ.get(f"GR_DTL_MH_{k.upper()}", v))
            for k, v in DEFAULTS.items()}


def _workload(txcfg, S, F, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    maxb = txcfg.max_frame_bytes()
    plen = np.full((S, F), txcfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((S, F, maxb), np.uint8)
    for s in range(S):
        for f in range(F):
            payload[s, f, : plen[s, f]] = rng.randint(0, 256, plen[s, f])
    cnst = np.full((S, F), 2, np.int32)
    frame_no = np.tile(np.arange(F, dtype=np.int32), (S, 1))
    return payload, plen, cnst, frame_no


def _run_steps(step, mesh, payload, plen, cnst, frame_no, steps, warmup):
    """Run loopback steps on globally-sharded inputs; returns a dict of
    (seconds_per_step, cpu_seconds_per_step, frames_checked).  Timing is
    value-chained: each step's key is folded with a scalar read off the
    previous step's output, so steps cannot overlap."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    def gshard(x, spec):
        s = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, s, lambda i: x[i])

    args = (gshard(payload, P("stream", "time")),
            gshard(plen, P("stream", "time")),
            gshard(cnst, P("stream", "time")),
            gshard(frame_no, P("stream", "time")))

    def one(i, chain):
        key = jax.random.fold_in(jax.random.PRNGKey(1 + i), chain)
        out = step(*args, key)
        # value-chain: a scalar fetched from this step feeds the next key
        return int(np.asarray(out.crc_ok.addressable_shards[0].data).ravel()[0])

    # compile + warmup; assert full decode once on the compiled output
    out = step(*args, jax.random.PRNGKey(0))
    ok_local = np.concatenate(
        [np.asarray(sh.data).reshape(-1) for sh in out.crc_ok.addressable_shards])
    assert ok_local.all(), "warmup step failed to decode every frame"
    for i in range(warmup):
        assert one(1000 + i, 0) == 1

    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.monotonic()
    chain = 0
    for i in range(steps):
        chain = one(i, chain)
        assert chain == 1
    wall = time.monotonic() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
    return {
        "sec_per_step": wall / steps,
        "cpu_sec_per_step": cpu / steps,
        "cpu_utilization": cpu / wall if wall > 0 else 0.0,
        "frames_per_step": int(np.prod(plen.shape)),
    }


def _build_and_run(mesh, p, streams):
    from gr_dtl_jax.parallel import stream as pstream
    from gr_dtl_jax.utils import config as cfgmod

    txcfg = cfgmod.make_tx_config(None, frame_length=p["frame_length"])
    rxcfg = cfgmod.make_rx_config(None, frame_length=p["frame_length"])
    step, _ = pstream.build_sharded_loopback(
        txcfg, rxcfg, mesh, frames_per_block=p["frames_per_block"],
        noise_v=0.01)
    F = mesh.shape["time"] * p["frames_per_block"]
    payload, plen, cnst, frame_no = _workload(txcfg, streams, F)
    res = _run_steps(step, mesh, payload, plen, cnst, frame_no,
                     p["steps"], p["warmup"])
    res["samples_per_step"] = res["frames_per_step"] * rxcfg.frame_samples
    return res


def worker(args):
    os.environ.setdefault("XLA_FLAGS", "")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from gr_dtl_jax.parallel import dist

    assert dist.init(), "dist.init() did not initialize jax.distributed"
    n_proc = jax.process_count()
    assert n_proc == int(os.environ["JAX_NUM_PROCESSES"])
    p = _params()
    mesh = dist.make_host_mesh(n_time=p["n_time"])
    res = _build_and_run(mesh, p, p["streams"])
    res.update({
        "process_id": jax.process_index(),
        "n_processes": n_proc,
        "global_devices": jax.device_count(),
        "local_devices": jax.local_device_count(),
        "mesh": dict(mesh.shape),
        "crc_ok": True,
    })
    print("WORKER_RESULT " + json.dumps(res), flush=True)


def session_worker(args):
    """One process of a REAL 2-process continuous sharded streaming
    session: ShardedStreamRx over the global (stream, time) mesh with
    carried state chained across process() calls THROUGH the
    distributed mesh — the always-on multi-host mode (the one-shot
    loopback steps of --worker prove the SPMD step; this proves the
    session)."""
    import numpy as np

    os.environ.setdefault("XLA_FLAGS", "")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from gr_dtl_jax.parallel import dist

    assert dist.init(), "dist.init() did not initialize jax.distributed"
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from gr_dtl_jax.models import transmitter
    from gr_dtl_jax.ops import channel, constellation as cn
    from gr_dtl_jax.parallel.session import ShardedStreamRx
    from gr_dtl_jax.utils import config as cfgmod

    p = _params()
    mesh = dist.make_host_mesh(n_time=p["n_time"])
    S_streams = p["streams"]
    F = p["frames_per_block"]
    n_blocks = 3
    cfg = cfgmod.make_rx_config(None, frame_length=p["frame_length"])
    txcfg = cfgmod.make_tx_config(None, frame_length=p["frame_length"])
    srx = ShardedStreamRx(cfg, mesh, n_streams=S_streams,
                          frames_per_block=F)
    blk = srx.block_samples
    B = (n_blocks - 1) * F  # trailing idle air

    # every process generates the SAME input deterministically on its
    # local CPU; the session uploads only each host's addressable shards
    streams = np.zeros((S_streams, n_blocks * blk), np.complex64)
    payloads, plens = [], []
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        txp = transmitter.build_tx(txcfg)
        maxb = txcfg.max_frame_bytes()
        for s in range(S_streams):
            rng = np.random.RandomState(60 + s)
            cnst = rng.randint(1, 5, B).astype(np.int32)
            pay = np.zeros((B, maxb), np.uint8)
            plen = np.zeros(B, np.int32)
            for i in range(B):
                plen[i] = txcfg.frame_bytes(
                    int(cn.BITS_PER_SYMBOL[cnst[i]])) - 4
                pay[i, : plen[i]] = rng.randint(0, 256, plen[i])
            out = transmitter.tx_frames(
                txp, jnp.asarray(pay), jnp.asarray(plen),
                jnp.asarray(cnst), jnp.zeros(B, jnp.int32),
                jnp.arange(B, dtype=jnp.int32), jax.random.PRNGKey(s))
            flat = np.asarray(out.samples).reshape(-1)
            sig = float(np.mean(np.abs(flat) ** 2))
            off = 120 + 67 * s
            streams[s, off: off + flat.size] = flat
            streams[s] = np.asarray(channel.awgn(
                jax.random.PRNGKey(200 + s), jnp.asarray(streams[s]),
                float(np.sqrt(sig / 1e3))))
            payloads.append(pay)
            plens.append(plen)

    decoded = [dict() for _ in range(S_streams)]
    for b in range(n_blocks):
        out, valid = srx.process(streams[:, b * blk: (b + 1) * blk])
        pays = np.asarray(multihost_utils.process_allgather(
            out.payload, tiled=True))
        lens = np.asarray(multihost_utils.process_allgather(
            out.payload_len, tiled=True))
        nos = np.asarray(multihost_utils.process_allgather(
            out.frame_no, tiled=True))
        ok = valid & srx.last_crc_ok
        for s in range(S_streams):
            for i in np.nonzero(ok[s])[0]:
                decoded[s][int(nos[s][i])] = (
                    pays[s][i, : lens[s][i]].tobytes())
    exact = all(
        len(decoded[s]) == B
        and all(decoded[s][i] == payloads[s][i, : plens[s][i]].tobytes()
                for i in range(B))
        for s in range(S_streams))
    res = {
        "process_id": jax.process_index(),
        "n_processes": jax.process_count(),
        "global_devices": jax.device_count(),
        "local_devices": jax.local_device_count(),
        "mesh": dict(mesh.shape),
        "streams": S_streams,
        "chained_blocks": n_blocks,
        "frames_decoded": int(sum(len(d) for d in decoded)),
        "byte_exact": bool(exact),
        "lost_frames": int(srx.n_lost.sum()),
    }
    print("SESSION_RESULT " + json.dumps(res), flush=True)
    assert exact, "distributed session decode mismatch"


def launch_session(procs: int, devices_per_proc: int, p: dict):
    """Spawn a REAL multi-process continuous sharded session."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    mh_env = {f"GR_DTL_MH_{k.upper()}": str(v) for k, v in p.items()}

    def env_for(pid):
        e = dict(os.environ)
        e.update(mh_env)
        e.update({
            "JAX_COORDINATOR": coord,
            "JAX_NUM_PROCESSES": str(procs),
            "JAX_PROCESS_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS":
                f"--xla_force_host_platform_device_count={devices_per_proc}",
        })
        return e

    ps = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--session-worker"],
        env=env_for(i), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(procs)]
    outs = [proc.communicate(timeout=3600)[0] for proc in ps]
    workers = []
    for i, (proc, o) in enumerate(zip(ps, outs)):
        if proc.returncode != 0:
            sys.stderr.write(f"--- session worker {i} failed ---\n{o}\n")
            raise SystemExit(f"session worker {i} exited {proc.returncode}")
        line = [l for l in o.splitlines()
                if l.startswith("SESSION_RESULT ")]
        workers.append(json.loads(line[-1][len("SESSION_RESULT "):]))
    result = {
        "mode": "distributed-session",
        "n_processes": procs,
        "workers": workers,
        "byte_exact_all": all(w["byte_exact"] for w in workers),
        "note": f"{procs} OS processes, gloo collectives: the CONTINUOUS "
                "sharded session (carried tail/lock/accounting state "
                "chained across process() calls on the global mesh), "
                "3 chained blocks, byte-exact decode of every stream "
                "asserted in every process",
    }
    print(json.dumps(result, indent=2))
    return result


def baseline(n_devices: int, half: bool = False):
    """Single-process reference points.

    strong (half=False): all n_devices virtual devices, the FULL global
    workload — isolates cross-process overhead.
    weak (half=True): one host's devices and one host's share of the
    streams — measures whether a second host adds proportional capacity.
    """
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gr_dtl_jax.parallel import dist

    p = _params()
    mesh = dist.make_host_mesh(n_time=p["n_time"])
    assert jax.device_count() == n_devices
    streams = p["streams"] // 2 if half else p["streams"]
    res = _build_and_run(mesh, p, streams)
    res["devices"] = jax.device_count()
    tag = "BASELINE_HALF_RESULT" if half else "BASELINE_RESULT"
    print(tag + " " + json.dumps(res), flush=True)


def launch(procs: int, devices_per_proc: int, out_path: str | None,
           p: dict):
    # pick a free coordinator port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    mh_env = {f"GR_DTL_MH_{k.upper()}": str(v) for k, v in p.items()}

    def env_for(pid):
        e = dict(os.environ)
        e.update(mh_env)
        e.update({
            "JAX_COORDINATOR": coord,
            "JAX_NUM_PROCESSES": str(procs),
            "JAX_PROCESS_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices_per_proc}",
        })
        return e

    ps = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker"],
        env=env_for(i), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(procs)]
    outs = [proc.communicate(timeout=3600)[0] for proc in ps]
    workers = []
    for i, (proc, o) in enumerate(zip(ps, outs)):
        if proc.returncode != 0:
            sys.stderr.write(f"--- worker {i} failed ---\n{o}\n")
            raise SystemExit(f"worker {i} exited {proc.returncode}")
        line = [l for l in o.splitlines() if l.startswith("WORKER_RESULT ")]
        workers.append(json.loads(line[-1][len("WORKER_RESULT "):]))

    def run_base(argv, n_dev, tag):
        e = dict(os.environ)
        e.update(mh_env)
        e.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": f"--xla_force_host_platform_device_count={n_dev}",
        })
        e.pop("JAX_COORDINATOR", None)
        o = subprocess.run(
            [sys.executable, os.path.abspath(__file__)] + argv,
            env=e, capture_output=True, text=True, timeout=3600)
        if o.returncode != 0:
            sys.stderr.write(o.stdout + o.stderr)
            raise SystemExit(f"{tag} baseline run failed")
        line = [l for l in o.stdout.splitlines() if l.startswith(tag + " ")]
        return json.loads(line[-1][len(tag) + 1:])

    # strong base: one process, all devices, full workload
    base = run_base(["--baseline", str(procs * devices_per_proc)],
                    procs * devices_per_proc, "BASELINE_RESULT")
    # weak base: one process, one host's devices, half the streams
    base_half = run_base(
        ["--baseline", str(devices_per_proc), "--half"],
        devices_per_proc, "BASELINE_HALF_RESULT")

    worst = max(w["sec_per_step"] for w in workers)
    eff_strong = base["sec_per_step"] / worst if worst > 0 else 0.0
    # weak scaling: N hosts should do N x the half-workload in the half
    # workload's time
    eff_weak = base_half["sec_per_step"] / worst if worst > 0 else 0.0
    n_cores = os.cpu_count() or 1
    result = {
        "n_processes": procs,
        "devices_per_process": devices_per_proc,
        "coordinator": coord,
        "workload": p,
        "workers": workers,
        "single_process_baseline": base,
        "half_workload_baseline": base_half,
        "sec_per_step_distributed": worst,
        "sec_per_step_single": base["sec_per_step"],
        # same global work, same global devices: 1.0 = no cross-process
        # overhead.
        "efficiency_vs_single_process": round(eff_strong, 4),
        # half work on one "host" vs full work on two: 1.0 = the second
        # host added its full capacity.  On this box the hosts share
        # n_cores silicon, so the per-process cpu_utilization figures
        # below bound what's achievable (see contention_analysis).
        "efficiency_weak_scaling": round(eff_weak, 4),
        "host_cores": n_cores,
        "contention_analysis": {
            "worker_cpu_utilization": [w["cpu_utilization"] for w in workers],
            "baseline_cpu_utilization": base["cpu_utilization"],
            "note": "cpu_utilization = process CPU-sec / wall-sec over the "
                    "timed steps.  If the workers' summed utilization "
                    "saturates host_cores, the distributed number is "
                    "CPU-contention-bound, not communication-bound.",
        },
        "crc_ok_all": all(w["crc_ok"] for w in workers),
        "note": f"{procs} OS processes, gloo CPU collectives, global "
                "(stream,time) mesh, ppermute halos + psum phase vote "
                "cross boundary; byte-exact decode asserted in every "
                "process",
    }
    print(json.dumps(result, indent=2))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--launch", action="store_true")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--session", action="store_true",
                    help="launch the CONTINUOUS sharded session across "
                         "--procs OS processes (ShardedStreamRx over "
                         "the global mesh, chained blocks)")
    ap.add_argument("--session-worker", action="store_true")
    ap.add_argument("--baseline", type=int, default=0)
    ap.add_argument("--half", action="store_true",
                    help="with --baseline: weak-scaling base (one host's "
                         "devices, half the streams)")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--out", default=None)
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k.replace('_', '-')}", type=int, default=None)
    args = ap.parse_args()
    if args.worker:
        worker(args)
    elif args.session_worker:
        session_worker(args)
    elif args.session:
        p = {k: (getattr(args, k) if getattr(args, k) is not None
                 else int(os.environ.get(f"GR_DTL_MH_{k.upper()}", v)))
             for k, v in DEFAULTS.items()}
        launch_session(args.procs, args.devices_per_proc, p)
    elif args.baseline:
        baseline(args.baseline, half=args.half)
    else:
        p = {k: (getattr(args, k) if getattr(args, k) is not None
                 else int(os.environ.get(f"GR_DTL_MH_{k.upper()}", v)))
             for k, v in DEFAULTS.items()}
        launch(args.procs, args.devices_per_proc, args.out, p)


if __name__ == "__main__":
    main()
