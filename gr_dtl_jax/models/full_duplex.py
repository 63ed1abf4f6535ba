"""Full-duplex adaptive modem: two nodes, in-band MCS adaptation.

Mirrors the reference's ``ofdm_adaptive_full_duplex``
(``python/dtl/ofdm_adaptive_full_duplex.py:21-43`` and call stack
SURVEY.md §3.3/3.4): each node's RX measures the SNR of its inbound
link and runs the feedback decision; the decision is *echoed* in the
4-bit ``feedback_constellation`` field of the node's outgoing headers;
the peer switches its TX constellation to the echoed value when the
header CRC passes (``ofdm_adaptive_frame_bb_impl.cc:111-130``).

Design: the whole bidirectional session is one
``lax.scan`` over rounds; both directions' TX+channel+RX run inside
the jitted step, with the adaptation state (feedback decision state,
current TX constellations, frame counters) as the scan carry.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.ops import channel as chan
from gr_dtl_jax.ops import constellation as cn
from gr_dtl_jax.models import adaptive, receiver, transmitter

__all__ = ["DuplexState", "build_full_duplex", "initial_duplex_state"]


class NodeState(NamedTuple):
    fb: adaptive.FeedbackState  # decision state for the inbound link
    tx_cnst: jax.Array  # current TX constellation (peer-controlled)
    tx_fec: jax.Array  # current TX FEC code id (peer-controlled; 0 = none)
    frame_no: jax.Array


class DuplexState(NamedTuple):
    a: NodeState
    b: NodeState


def initial_duplex_state(cfg, tables) -> DuplexState:
    init_cnst = jnp.asarray(tables["cnst"])[cfg.initial_mcs_id]
    init_fec = jnp.asarray(tables["fec"])[cfg.initial_mcs_id]

    def node():
        return NodeState(
            fb=adaptive.initial_state(cfg.initial_mcs_id),
            tx_cnst=jnp.asarray(init_cnst, jnp.int32),
            tx_fec=jnp.asarray(init_fec, jnp.int32),
            frame_no=jnp.asarray(0, jnp.int32),
        )

    return DuplexState(a=node(), b=node())


def build_full_duplex(cfg, *, noise_ab: float, noise_ba: float, fec=None):
    """Jitted bidirectional session runner.

    Args:
      cfg: modem config (both nodes share it).
      noise_ab/noise_ba: AWGN noise voltage on the A->B / B->A links.
      fec: optional fec_chain.build_fec table — runs the session on the
        LDPC transport-block path (long headers); the MCS echo then also
        carries the requested FEC scheme in the ``fec_feedback`` field
        (ref fec_frame_bvb_impl.cc:178-201 switch semantics).
    Returns ``run(state, key, n_rounds)`` -> (state, telemetry dict of
    [n_rounds] arrays).
    """
    txp = transmitter.build_tx(cfg, fec)
    rxp = receiver.build_rx(cfg, fec)
    tables = adaptive.build_mcs_tables(cfg)
    bps_table = jnp.asarray(cn.BITS_PER_SYMBOL)
    cnst_of_mcs = jnp.asarray(tables["cnst"])
    fec_of_mcs = jnp.asarray(tables["fec"])
    n_codes = fec["n_codes"] if fec is not None else 0
    if fec is not None:
        maxb = fec["max_payload_bytes"]
        # capacity depends on BOTH the code and the constellation
        cap_tab2 = jnp.asarray(fec["user_bytes_tab2"], jnp.int32)
    else:
        maxb = cfg.max_frame_bytes()
        cap_per_bps = jnp.asarray(
            [0] + [cfg.frame_bytes(b) - 4 for b in range(1, 5)], jnp.int32
        )

    def send_one(node: NodeState, noise_v, key):
        """TX one frame from `node` with its current state."""
        kp, kpad, kn = jax.random.split(key, 3)
        if fec is not None:
            plen = cap_tab2[node.tx_fec, bps_table[node.tx_cnst]]
        else:
            plen = cap_per_bps[bps_table[node.tx_cnst]]
        payload = jax.random.randint(kp, (1, maxb), 0, 256, dtype=jnp.int32).astype(
            jnp.uint8
        )
        # contract: zero beyond payload_len (the framer random-pads the
        # no-FEC tail itself; the FEC TB builder expects zeros)
        payload = jnp.where(jnp.arange(maxb)[None, :] < plen, payload, 0)
        fb_cnst = cnst_of_mcs[node.fb.last]
        out = transmitter.tx_frames(
            txp,
            payload,
            plen[None],
            node.tx_cnst[None],
            fb_cnst[None],
            node.frame_no[None],
            kpad,
            fec_feedback=fec_of_mcs[node.fb.last][None],
            fec_id=node.tx_fec[None] if fec is not None else None,
        )
        rxsamp = chan.awgn(kn, out.samples, noise_v)
        return rxsamp

    def receive_one(node: NodeState, samples) -> tuple[NodeState, dict]:
        """RX one frame at `node`; update echo-driven TX state + decision."""
        rx = receiver.rx_frames(rxp, samples, fallback_cnst=node.tx_cnst[None])
        ok = rx.header_ok[0]
        echo = rx.feedback_cnst[0]
        echo_valid = ok & (echo >= 1) & (echo <= 4)
        new_tx_cnst = jnp.where(echo_valid, echo, node.tx_cnst)
        # the FEC echo switches the TX code too (ref
        # fec_frame_bvb_impl.cc:178-201)
        fec_echo = rx.fec_echo[0]
        fec_valid = ok & (fec_echo >= 1) & (fec_echo <= n_codes)
        new_tx_fec = jnp.where(fec_valid, fec_echo, node.tx_fec)
        fb, _ = adaptive.feedback_step(node.fb, rx.snr_db[0], tables)
        # only adapt on frames we actually decoded (ref: feedback comes
        # from the equalizer only when a frame was received)
        fb = jax.tree.map(lambda new, old: jnp.where(ok, new, old), fb, node.fb)
        new_node = NodeState(
            fb=fb,
            tx_cnst=new_tx_cnst,
            tx_fec=new_tx_fec,
            frame_no=(node.frame_no + 1) & 0xFFF,
        )
        telem = {
            "snr_db": rx.snr_db[0],
            "crc_ok": rx.crc_ok[0],
            "header_ok": ok,
            "rx_cnst": rx.cnst_id[0],
        }
        return new_node, telem

    def round_step(state: DuplexState, key):
        ka, kb = jax.random.split(key)
        samp_ab = send_one(state.a, noise_ab, ka)
        b_new, telem_b = receive_one(state.b, samp_ab)
        # B replies with its fresh echo
        state = DuplexState(a=state.a, b=b_new)
        samp_ba = send_one(state.b, noise_ba, kb)
        a_new, telem_a = receive_one(state.a, samp_ba)
        state = DuplexState(a=a_new, b=state.b)
        telem = {
            "a_tx_cnst": state.a.tx_cnst,
            "b_tx_cnst": state.b.tx_cnst,
            "a_tx_fec": state.a.tx_fec,
            "b_tx_fec": state.b.tx_fec,
            "snr_at_b": telem_b["snr_db"],
            "snr_at_a": telem_a["snr_db"],
            "b_crc_ok": telem_b["crc_ok"],
            "a_crc_ok": telem_a["crc_ok"],
        }
        return state, telem

    @functools.partial(jax.jit, static_argnames=("n_rounds",))
    def run(state: DuplexState, key: jax.Array, n_rounds: int = 32):
        keys = jax.random.split(key, n_rounds)
        return jax.lax.scan(round_step, state, keys)

    return run, tables
