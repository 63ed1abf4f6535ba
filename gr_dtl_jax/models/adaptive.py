"""Adaptive MCS control: SNR-threshold decision with hysteresis + counter.

Mirrors the reference decision policy *exactly*
(``lib/dtl/ofdm_adaptive_feedback_decision.cc:55-96``):

- the LUT maps MCS id -> (snr_threshold_dB, (constellation, fec));
  entry 0's threshold is -inf,
- if snr < threshold(current)            -> candidate = current - 1
- elif snr > threshold(current+1) + hyst -> candidate = current + 1
- else reset the consecutive counter,
- a candidate only becomes active after it has been proposed
  ``decision_th`` times in a row (counter reset on every change),
- defaults: hysteresis 1 dB, decision_th 5 (ref ofdm_receiver.py:167).

Design note: the decision is sequential across frames, so it
is a ``lax.scan`` over the frame sequence (per stream), vectorizable
over streams with ``vmap`` — not a host callback per frame like the
reference's message-port handler.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.ops.constellation import ConstellationType

__all__ = ["FeedbackState", "build_mcs_tables", "feedback_step", "feedback_scan",
           "initial_state"]


class FeedbackState(NamedTuple):
    last: jax.Array  # active MCS id
    cand: jax.Array  # candidate MCS id
    counter: jax.Array  # consecutive confirmations of cand


def build_mcs_tables(cfg):
    """LUT arrays from the config's mcs ladder (ref ofdm_adaptive_config.py:43-44)."""
    snr = np.array([s for s, _ in cfg.mcs], dtype=np.float32)
    snr[0] = -np.inf
    cnst = np.array([int(c) for _, (c, _) in cfg.mcs], dtype=np.int32)
    fec_names = [f for _, (_, f) in cfg.mcs]
    code_ids = {name: i + 1 for i, (name, _) in enumerate(cfg.fec_codes)}
    code_ids["no_fec"] = 0
    fec = np.array([code_ids.get(f, 0) for f in fec_names], dtype=np.int32)
    return {
        "snr_th": snr,
        "cnst": cnst,
        "fec": fec,
        "n_mcs": len(cfg.mcs),
        "hysteresis": 1.0,
        "decision_th": 5,
    }


def initial_state(mcs_id: int = 0, batch_shape=()) -> FeedbackState:
    z = jnp.full(batch_shape, mcs_id, jnp.int32)
    return FeedbackState(last=z, cand=z, counter=jnp.zeros(batch_shape, jnp.int32))


def feedback_step(state: FeedbackState, snr_db: jax.Array, tables) -> tuple[FeedbackState, jax.Array]:
    """One decision update. snr_db and state fields share a batch shape."""
    snr_th = jnp.asarray(tables["snr_th"])
    n = tables["n_mcs"]
    hyst = tables["hysteresis"]
    th = tables["decision_th"]

    cur = state.last
    down = snr_db < snr_th[cur]
    can_up = cur + 1 < n
    up = can_up & (snr_db > snr_th[jnp.clip(cur + 1, 0, n - 1)] + hyst)

    candidate = jnp.where(down, jnp.maximum(cur - 1, 0), jnp.where(up, cur + 1, cur))
    propose = down | up

    changed = candidate != state.cand
    new_cand = jnp.where(propose & changed, candidate, state.cand)
    new_counter = jnp.where(
        propose,
        jnp.where(changed, 0, state.counter + 1),
        0,
    )
    commit = propose & ~changed & (new_counter >= th)
    new_last = jnp.where(commit, new_cand, state.last)
    new_counter = jnp.where(commit, 0, new_counter)
    new_state = FeedbackState(last=new_last, cand=new_cand, counter=new_counter)
    return new_state, new_last


def feedback_scan(state: FeedbackState, snrs_db: jax.Array, tables):
    """Sequential decisions over [T] (or [T, ...batch]) SNR estimates.

    Returns (final_state, mcs_ids [T, ...]).
    """
    def step(s, snr):
        return feedback_step(s, snr, tables)

    return jax.lax.scan(step, state, snrs_db)
