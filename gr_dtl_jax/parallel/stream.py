"""Sharded receiver: many streams x time-blocked sample timelines.

Design note
-----------
This layer replaces the GNU Radio scheduler's concurrency (SURVEY.md
§2f) with SPMD over a ``(stream, time)`` mesh:

- the **stream axis** shards independent adaptive-OFDM channels (pure
  data parallelism; no cross-talk),
- the **time axis** shards one channel's sample timeline into
  contiguous blocks.  The Schmidl-Cox correlator and frame extraction
  need to look past a block's right edge, so each shard fetches a halo
  of ``frame_samples + fft_len`` samples from its right neighbour with
  ``jax.lax.ppermute`` (overlap-save between neighbouring devices), and the frame-phase
  vote is made global with a ``psum`` so every block agrees on trigger
  positions ("trigger ownership": a frame belongs to the block its
  start sample lies in).

Block length must be a multiple of ``frame_samples`` so the folded
trigger phase is identical in every block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from gr_dtl_jax.ops import channel as chan
from gr_dtl_jax.ops import sync
from gr_dtl_jax.models import receiver, transmitter

__all__ = ["build_sharded_rx", "build_sharded_loopback"]


def _make_local_block_rx(cfg, rxp, frames_per_block: int, block: int):
    """One stream's local block + right halo -> frames_per_block results.

    The frame-phase vote is local to the block but made global with a
    ``psum`` over the time axis, so every block agrees on trigger
    positions ("trigger ownership": a frame belongs to the block its
    start sample lies in).
    """
    frame_samples = cfg.frame_samples

    def local_block_rx(ext):
        """ext: [block + halo] samples."""
        Pm, M = sync.timing_metric(ext, cfg.fft_len)
        # local vote over the block only (exclude halo to keep votes
        # disjoint), then global consensus across time blocks
        n_full = block // frame_samples
        folded = jnp.sum(
            M[: n_full * frame_samples].reshape(n_full, frame_samples), axis=0
        )
        folded = jax.lax.psum(folded, "time")
        # circular plateau-center vote (a raw argmax can land on the
        # wrap edge and make every block decode its neighbour's frame
        # through the halo)
        phase = sync.phase_from_folded(folded, frame_samples, cfg.cp_len)
        trig = sync.frame_triggers(M, phase, frame_samples, frames_per_block)
        eps = sync.fine_cfo(Pm, trig, cfg.cp_len, period=frame_samples)
        frames = sync.cfo_correct(
            sync.extract_frames(ext, trig, frame_samples), eps, cfg.fft_len)
        return receiver.rx_frames(rxp, frames)

    return local_block_rx


def build_sharded_rx(cfg, mesh, frames_per_block: int):
    """Jitted sharded receiver over a (stream, time) mesh.

    Returns ``fn(streams) -> RxOut-pytree`` where ``streams`` is
    ``[n_streams, n_blocks*block_samples]`` complex64 and every leaf of
    the result has leading dims ``[n_streams, n_blocks*frames_per_block]``.
    """
    rxp = receiver.build_rx(cfg)
    frame_samples = cfg.frame_samples
    block = frames_per_block * frame_samples
    halo = frame_samples + cfg.fft_len  # finish boundary frames + metric window
    n_time = mesh.shape["time"]

    local_block_rx = _make_local_block_rx(cfg, rxp, frames_per_block, block)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P("stream", "time"),
        out_specs=P("stream", "time"),
        check_vma=False,
    )
    def rx_sharded(streams_block):
        # local view: [S_local, block]
        right = jax.lax.ppermute(
            streams_block[:, :halo],
            "time",
            [(i, (i - 1) % n_time) for i in range(n_time)],
        )
        ext = jnp.concatenate([streams_block, right], axis=1)
        out = jax.vmap(local_block_rx)(ext)
        return out

    def fn(streams):
        return rx_sharded(streams)

    return jax.jit(fn), rxp


def build_sharded_loopback(txcfg, rxcfg, mesh, frames_per_block: int,
                           noise_v: float, fec=None):
    """Full sharded modem step: TX + channel + RX in one ``shard_map``.

    The multi-device modem step: payloads sharded ``(stream, time)``
    are framed/modulated locally (TX has no cross-shard deps), pass
    through a per-shard AWGN channel, and are demodulated by the halo-
    exchanging sharded receiver — one jitted SPMD program, collectives
    (``ppermute`` halo + ``psum`` phase vote) over the mesh.

    Returns ``fn(payload, plen, cnst, frame_no, key) -> RxOut`` with
    inputs shaped ``[n_streams, n_blocks*frames_per_block, ...]`` and
    key a scalar PRNG key (folded per shard).
    """
    txp = transmitter.build_tx(txcfg, fec)
    rxp = receiver.build_rx(rxcfg, fec)
    frame_samples = rxcfg.frame_samples
    block = frames_per_block * frame_samples
    halo = frame_samples + rxcfg.fft_len
    n_time = mesh.shape["time"]

    local_block_rx = _make_local_block_rx(rxcfg, rxp, frames_per_block, block)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("stream", "time"), P("stream", "time"),
                  P("stream", "time"), P("stream", "time"), P()),
        out_specs=P("stream", "time"),
        check_vma=False,
    )
    def step(payload, plen, cnst, frame_no, key):
        S_local, F_local = plen.shape
        # per-shard independent randomness
        key = jax.random.fold_in(key, jax.lax.axis_index("stream"))
        key = jax.random.fold_in(key, jax.lax.axis_index("time"))
        kpad, kn = jax.random.split(key)
        out = transmitter.tx_frames(
            txp,
            payload.reshape(S_local * F_local, -1),
            plen.reshape(-1), cnst.reshape(-1), jnp.zeros_like(plen).reshape(-1),
            frame_no.reshape(-1), kpad,
        )
        streams = out.samples.reshape(S_local, F_local * frame_samples)
        streams = chan.awgn(kn, streams, noise_v)
        right = jax.lax.ppermute(
            streams[:, :halo], "time",
            [(i, (i - 1) % n_time) for i in range(n_time)],
        )
        ext = jnp.concatenate([streams, right], axis=1)
        return jax.vmap(local_block_rx)(ext)

    return jax.jit(step), (txp, rxp)
