"""Simplex adaptive modem: OFDM forward link + narrowband burst reverse.

Mirrors the reference's ``ofdm_adaptive_tx`` / ``ofdm_adaptive_rx``
pair (SURVEY.md #41/#42, call stacks §3.1-3.2): the TX node sends OFDM
frames and listens for feedback bursts on the reverse channel; the RX
node demodulates frames, runs the MCS decision on its SNR estimate and
transmits the decision as a BPSK burst (access code + constellation +
FEC + CRC8).  On burst reception the TX switches its constellation
(ref ``framer.process_feedback`` — in the simplex topology the burst
carries the actual MCS to use, frame_bb_impl.cc:88-109).

Design: each node's per-round work is one jitted step; the
bidirectional session is a ``lax.scan`` like models/full_duplex.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gr_dtl_jax.ops import burst, channel as chan, constellation as cn
from gr_dtl_jax.models import adaptive, receiver, transmitter

__all__ = ["SimplexState", "build_simplex", "initial_simplex_state"]


class SimplexState(NamedTuple):
    tx_cnst: jax.Array  # TX node's current constellation (burst-controlled)
    rx_fb: adaptive.FeedbackState  # RX node's decision state
    frame_no: jax.Array


def initial_simplex_state(cfg, tables) -> SimplexState:
    init_cnst = jnp.asarray(tables["cnst"])[cfg.initial_mcs_id]
    return SimplexState(
        tx_cnst=jnp.asarray(init_cnst, jnp.int32),
        rx_fb=adaptive.initial_state(cfg.initial_mcs_id),
        frame_no=jnp.asarray(0, jnp.int32),
    )


def build_simplex(cfg, *, noise_fwd: float, noise_rev: float):
    """Jitted simplex session: forward OFDM + reverse burst, both lossy.

    Returns (run(state, key, n_rounds) -> (state, telemetry), tables).
    """
    txp = transmitter.build_tx(cfg)
    rxp = receiver.build_rx(cfg)
    tables = adaptive.build_mcs_tables(cfg)
    modem = burst.build_burst_modem()
    bps_table = jnp.asarray(cn.BITS_PER_SYMBOL)
    cnst_of_mcs = jnp.asarray(tables["cnst"])
    fec_of_mcs = jnp.asarray(tables["fec"])
    maxb = cfg.max_frame_bytes()
    cap_per_bps = jnp.asarray(
        [0] + [cfg.frame_bytes(b) - 4 for b in range(1, 5)], jnp.int32
    )

    def round_step(state: SimplexState, key):
        kp, kpad, kn, kb = jax.random.split(key, 4)
        # --- forward link: TX node -> RX node ---
        plen = cap_per_bps[bps_table[state.tx_cnst]]
        payload = jax.random.randint(kp, (1, maxb), 0, 256, dtype=jnp.int32).astype(
            jnp.uint8
        )
        out = transmitter.tx_frames(
            txp, payload, plen[None], state.tx_cnst[None],
            cnst_of_mcs[state.rx_fb.last][None],  # unused echo in simplex
            state.frame_no[None], kpad,
        )
        fwd = chan.awgn(kn, out.samples, noise_fwd)
        rx = receiver.rx_frames(rxp, fwd, fallback_cnst=state.tx_cnst[None])

        # --- RX node decision + reverse burst ---
        fb, _ = adaptive.feedback_step(state.rx_fb, rx.snr_db[0], tables)
        fb = jax.tree.map(
            lambda new, old: jnp.where(rx.header_ok[0], new, old), fb, state.rx_fb
        )
        want_cnst = cnst_of_mcs[fb.last]
        want_fec = fec_of_mcs[fb.last]
        wave = burst.burst_tx(want_cnst[None], want_fec[None], modem)
        rev = chan.awgn(kb, wave, noise_rev)
        fb_rx = burst.burst_rx(rev, modem)

        # --- TX node applies the burst (ref process_feedback:88-109) ---
        got = fb_rx.ok[0] & (fb_rx.cnst_id[0] >= 1) & (fb_rx.cnst_id[0] <= 4)
        new_tx_cnst = jnp.where(got, fb_rx.cnst_id[0], state.tx_cnst)

        new_state = SimplexState(
            tx_cnst=new_tx_cnst, rx_fb=fb, frame_no=(state.frame_no + 1) & 0xFFF
        )
        telem = {
            "tx_cnst": new_tx_cnst,
            "snr_db": rx.snr_db[0],
            "crc_ok": rx.crc_ok[0],
            "burst_ok": fb_rx.ok[0],
            "requested": want_cnst,
        }
        return new_state, telem

    @functools.partial(jax.jit, static_argnames=("n_rounds",))
    def run(state: SimplexState, key: jax.Array, n_rounds: int = 32):
        keys = jax.random.split(key, n_rounds)
        return jax.lax.scan(round_step, state, keys)

    return run, tables
