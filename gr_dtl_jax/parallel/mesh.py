"""Device mesh construction for multi-stream / time-block sharding.

The reference has no distributed execution at all (SURVEY.md §2f): its
"parallelism" is the GNU Radio thread-per-block scheduler.  Here scale
comes from a ``jax.sharding.Mesh`` with two axes:

- ``stream``: independent adaptive-OFDM channels (data parallelism —
  BASELINE config 5's "64 streams over N hosts"),
- ``time``:   contiguous blocks of one stream's sample timeline
  (sequence parallelism with overlap-save halo exchange).

The cards of one host are joined all to all (NVLink), so the mesh
follows the algorithm, not a physical topology: any device order works
equally well.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = ["make_mesh"]


def make_mesh(n_stream: int | None = None, n_time: int = 1,
              devices=None) -> Mesh:
    """Build a (stream, time) mesh over the available devices.

    Args:
      n_stream: devices along the stream (channel) axis; defaults to
                all devices / n_time.
      n_time:   devices along the time (sequence) axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_stream is None:
        n_stream = len(devices) // n_time
    n = n_stream * n_time
    dev = np.array(devices[:n]).reshape(n_stream, n_time)
    return Mesh(dev, axis_names=("stream", "time"))
