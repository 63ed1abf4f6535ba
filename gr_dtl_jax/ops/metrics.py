"""Diagnostic metrics: constellation error metric + lost-frame tracking.

- :func:`constellation_metric` mirrors
  ``ofdm_adaptive_constellation_metric_vcvf`` (ref
  ofdm_adaptive_constellation_metric_vcvf_impl.cc:103-149): per-subcarrier
  mean squared error between decided and soft (pre-decision) symbols,
  normalized by the constellation's minimum point distance — vectorized
  over a batch of frames instead of per-symbol host loops.

- :func:`lost_frames` mirrors the frame-number gap counter of the
  reference's frame equalizer
  (ofdm_adaptive_frame_equalizer_vcvc_impl.cc:124-137): the 12-bit
  frame number is compared against the expected sequence; gaps count as
  lost frames (mod-4096 wrap handled).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gr_dtl_jax.ops import constellation as cn

__all__ = ["constellation_metric", "lost_frames"]


def constellation_metric(hard: jax.Array, soft: jax.Array,
                         cnst_id: jax.Array) -> jax.Array:
    """Per-subcarrier normalized error metric.

    Args:
      hard: [B, n_sym, n_carriers] decided symbols.
      soft: same shape, equalized pre-decision symbols.
      cnst_id: [B] constellation ids.
    Returns [B, n_carriers] float32: mean |hard - soft|^2 over symbols,
    divided by the constellation's min distance.
    """
    err = jnp.mean(jnp.abs(hard - soft) ** 2, axis=1)  # [B, n_carriers]
    mind = jnp.asarray(cn.MIN_DIST)[jnp.asarray(cnst_id)]
    return (err / jnp.maximum(mind[:, None], 1e-12)).astype(jnp.float32)


def lost_frames(frame_no: jax.Array, header_ok: jax.Array,
                expected_first: jax.Array | int = None):
    """Count lost frames from a received frame-number sequence.

    Args:
      frame_no:  [B] received 12-bit frame numbers, in arrival order.
      header_ok: [B] bool; frames with bad headers are themselves counted
                 lost and do not advance the expected counter.
      expected_first: expected number of the first frame (defaults to
                 frame_no[0], i.e. the stream starts in sync).
    Returns (n_lost, n_total, rate): scalars; rate = lost / total like
    the reference's d_lost_frames / d_frames_count.
    """
    frame_no = jnp.asarray(frame_no)
    header_ok = jnp.asarray(header_ok)
    if expected_first is None:
        expected_first = frame_no[0]

    def step(expected, x):
        no, ok = x
        gap = (no - expected) % 4096
        lost = jnp.where(ok, gap, 1)  # bad header: that frame is lost
        new_expected = jnp.where(ok, (no + 1) % 4096, (expected + 1) % 4096)
        return new_expected, lost

    _, losts = jax.lax.scan(step, jnp.asarray(expected_first) % 4096,
                            (frame_no, header_ok))
    n_lost = jnp.sum(losts)
    n_total = n_lost + jnp.sum(header_ok)
    rate = n_lost / jnp.maximum(n_total, 1)
    return n_lost, n_total, rate.astype(jnp.float32)
