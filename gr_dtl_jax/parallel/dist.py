"""Multi-host initialization: jax.distributed + host-aware meshes.

The reference has no distributed runtime at all (SURVEY.md §2f) — its
only cross-process transport is ZMQ telemetry.  Here multi-host scale
is first-class: BASELINE config 5 targets 64 adaptive-OFDM streams
sharded over N >= 2 hosts.

Design: the **stream axis maps to hosts** (pure data parallelism — no
cross-stream communication, so it rides the network between hosts
without ever blocking on it), and the **time axis stays inside a
host's cards** so the overlap-save ``ppermute`` halos of the sharded
receiver (parallel/stream.py) ride NVLink only.  That is the layout
:func:`make_host_mesh` builds; with it, the only network traffic in
steady state is input/output movement, giving near-linear host scaling
for independent streams.

Usage (same program on every host):

    from gr_dtl_jax.parallel import dist
    dist.init()                       # env-driven (JAX_COORDINATOR etc.)
    mesh = dist.make_host_mesh(n_time=2)
    step, _ = stream.build_sharded_loopback(txcfg, rxcfg, mesh, ...)

This module is exercised single-host in CI (virtual CPU devices make
``init`` a no-op); the mesh layout logic is host-count agnostic.
"""

from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = ["init", "make_host_mesh"]


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None) -> bool:
    """Initialize jax.distributed if a multi-process setup is requested.

    Reads ``JAX_COORDINATOR`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
    when args are omitted.  Returns True when distributed mode was
    initialized, False for the single-process (no-op) case — so the same
    launch script works on a laptop, one GPU host, or several hosts.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if not coordinator or num_processes <= 1:
        return False
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("JAX_PROCESS_ID", "0")))
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_host_mesh(n_time: int = 1, devices=None) -> Mesh:
    """(stream, time) mesh with hosts along the stream axis.

    Device order: ``jax.devices()`` groups by process; reshaping to
    ``[n_hosts * cards_per_host / n_time, n_time]`` keeps each host's
    cards contiguous, so every ``time`` ring (the ppermute halo path)
    stays on one host's NVLink and the stream axis crosses hosts only
    for data placement, never for collectives.

    Args:
      n_time: devices per time ring; must divide the per-host device
        count so a ring never crosses the network between hosts.
    """
    devices = list(devices if devices is not None else jax.devices())
    n_local = max(1, jax.local_device_count())
    if n_time > n_local or n_local % n_time != 0:
        raise ValueError(
            f"n_time={n_time} must divide the per-host device count "
            f"({n_local}) so halo rings stay within one host")
    n = len(devices)
    dev = np.array(devices).reshape(n // n_time, n_time)
    return Mesh(dev, axis_names=("stream", "time"))
