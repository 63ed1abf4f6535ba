"""Streaming-input plumbing: PDU packing and trigger lock tracking.

Two reference capabilities that live *around* the batched chains:

- :func:`pack_pdus` mirrors ``pdu_consumer`` (ref
  ``lib/dtl/pdu_consumer.cc:17-65``): frames consume whole PDUs up to
  the frame's byte capacity; a PDU larger than the capacity ("jumbo")
  is split across consecutive frames; otherwise PDUs never straddle a
  frame boundary.  This is TX input plumbing, so like the reference it
  runs on the host and feeds the jitted chain with padded arrays.

- :func:`trigger_lock_scan` mirrors the streaming part of
  ``ofdm_adaptive_frame_detect_bb`` (ref
  ``ofdm_adaptive_frame_detect_bb_impl.cc:21-22,64-173``): across
  successive stream blocks, per-block trigger candidates are tracked by
  a lock state machine — ``LOCK_AFTER=3`` consecutive period-consistent
  triggers to lock, ``UNLOCK_AFTER=5`` consecutive misses to unlock,
  missing triggers synthesized from the period while locked.  It is a
  ``lax.scan`` usable as the continuous-operation wrapper around
  ops/sync's batch detection.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pack_pdus", "pack_pdus_budget", "TriggerLockState",
           "trigger_lock_scan", "LOCK_AFTER", "UNLOCK_AFTER"]

LOCK_AFTER = 3  # consecutive synced triggers to lock (ref :21)
UNLOCK_AFTER = 5  # consecutive missing triggers to unlock (ref :22)


def pack_pdus(pdus: list[bytes], frame_capacity: int, max_frames: int | None = None):
    """Pack a PDU queue into frame payloads.

    Args:
      pdus: list of byte strings (network packets, etc.).
      frame_capacity: usable payload bytes per frame (capacity - CRC).
    Returns (payload [B, frame_capacity] uint8, payload_len [B] int32,
    boundaries: list of per-frame lists of (offset, len) PDU extents).
    """
    frames: list[bytearray] = []
    bounds: list[list[tuple[int, int]]] = []
    cur = bytearray()
    cur_bounds: list[tuple[int, int]] = []

    def flush():
        nonlocal cur, cur_bounds
        if cur:
            frames.append(cur)
            bounds.append(cur_bounds)
            cur = bytearray()
            cur_bounds = []

    for pdu in pdus:
        if len(pdu) > frame_capacity:
            # jumbo: split across frames (ref d_current_pdu_remain)
            flush()
            off = 0
            while off < len(pdu):
                chunk = pdu[off : off + frame_capacity]
                frames.append(bytearray(chunk))
                bounds.append([(0, len(chunk))])
                off += frame_capacity
            continue
        if len(cur) + len(pdu) > frame_capacity:
            flush()
        cur_bounds.append((len(cur), len(pdu)))
        cur += pdu
    flush()

    if max_frames is not None:
        frames = frames[:max_frames]
        bounds = bounds[:max_frames]
    B = len(frames)
    payload = np.zeros((B, frame_capacity), np.uint8)
    plen = np.zeros(B, np.int32)
    for i, f in enumerate(frames):
        payload[i, : len(f)] = np.frombuffer(bytes(f), np.uint8)
        plen[i] = len(f)
    return payload, plen, bounds


def pack_pdus_budget(queue: list[bytes], jumbo_rest: bytes, cap: int,
                     max_frames: int) -> tuple[list[bytes], bytes]:
    """Incremental :func:`pack_pdus` with a hard frame budget.

    Same whole-PDU/jumbo-split semantics, but consumes at most
    ``max_frames`` frames' worth of input: ``queue`` is popped in place
    (leftover PDUs stay queued), and an unfinished jumbo split is
    returned as the new ``jumbo_rest`` carry.  Used by the continuous
    :class:`gr_dtl_jax.models.session.StreamTx`.

    Returns (frames: list of per-frame payload bytes, jumbo_rest).
    """
    frames: list[bytes] = []
    cur = bytearray()
    if jumbo_rest:
        rest = jumbo_rest
        while rest and len(frames) < max_frames:
            frames.append(rest[:cap])
            rest = rest[cap:]
        jumbo_rest = rest
        if jumbo_rest:
            return frames, jumbo_rest
    else:
        jumbo_rest = b""
    while queue and len(frames) < max_frames:
        pdu = queue[0]
        if len(pdu) > cap:
            # jumbo: own frames, split; the tail chunk also gets its own
            # frame (pack_pdus semantics, ref d_current_pdu_remain)
            if cur:
                frames.append(bytes(cur))
                cur = bytearray()
                continue
            queue.pop(0)
            while pdu and len(frames) < max_frames:
                frames.append(pdu[:cap])
                pdu = pdu[cap:]
            jumbo_rest = pdu
            continue
        if len(cur) + len(pdu) > cap:
            frames.append(bytes(cur))
            cur = bytearray()
            continue
        cur += queue.pop(0)
    if cur and len(frames) < max_frames:
        frames.append(bytes(cur))
    return frames, jumbo_rest


class TriggerLockState(NamedTuple):
    locked: jax.Array  # bool
    expected: jax.Array  # int32 expected trigger position (stream units)
    sync_count: jax.Array  # consecutive consistent triggers
    miss_count: jax.Array  # consecutive misses while locked


def trigger_lock_scan(state: TriggerLockState, candidates: jax.Array,
                      found: jax.Array, period: int, tol: int = 4):
    """Track triggers across stream blocks with lock/unlock hysteresis.

    Args:
      state:      carry from the previous call.
      candidates: [T] int32 candidate trigger positions (absolute stream
                  sample index), one per expected frame slot.
      found:      [T] bool whether the detector saw a plausible metric
                  peak for that slot.
      period:     nominal frame period in samples.
      tol:        +- samples considered "consistent" (the reference
                  accumulates +-1 errors; batch detection gives a few).
    Returns (state, (triggers [T] int32, valid [T] bool)): corrected
    trigger positions (synthesized from the period when locked and the
    candidate is missing/off), and whether each should be demodulated.
    """

    def step(s: TriggerLockState, x):
        cand, ok = x
        consistent = ok & (jnp.abs(cand - s.expected) <= tol)
        # update sync/miss counters
        sync_count = jnp.where(consistent, s.sync_count + 1, jnp.where(ok, 1, 0))
        miss = ~consistent
        miss_count = jnp.where(s.locked & miss, s.miss_count + 1, 0)
        locked = jnp.where(sync_count >= LOCK_AFTER, True, s.locked)
        locked = jnp.where(miss_count >= UNLOCK_AFTER, False, locked)
        # output: trust candidate when consistent or unlocked-but-found;
        # synthesize from expectation when locked and missing
        trig = jnp.where(consistent | (~s.locked & ok), cand, s.expected)
        valid = consistent | (~s.locked & ok) | s.locked
        new_expected = trig + period
        return TriggerLockState(locked, new_expected, sync_count, miss_count), (
            trig, valid)

    return jax.lax.scan(step, state, (candidates.astype(jnp.int32), found))
