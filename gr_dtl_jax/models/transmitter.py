"""OFDM transmitter chain: payload bytes -> complex baseband samples.

Replaces the reference's TX hierarchy (``python/dtl/ofdm_transmitter.py:63-213``:
framer -> header generator + BPSK mod || payload mod -> tagged-stream
mux -> carrier allocator -> IFFT -> cyclic prefixer) with one jitted
function over a *batch of frames*: every per-frame quantity
(constellation, payload length, frame number, feedback echo) is an
array, the whole batch flows through fused tensor ops, and the size-64
IDFT runs as one matmul.  No scheduler, no per-block threads.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.ops import constellation as cn
from gr_dtl_jax.ops import gf2, header, ofdm, repack
from gr_dtl_jax.models import framing

__all__ = ["build_tx", "tx_frames", "TxOut"]


class TxOut(NamedTuple):
    samples: jax.Array  # [B, frame_samples] complex64 baseband
    frame_bytes: jax.Array  # [B, max_frame_bytes] the framed bytes (for BER tools)
    l_total: jax.Array  # [B] header payload-length field


def build_tx(cfg, fec=None):
    """Precompute all TX constants for a config.

    Args:
      fec: optional dict from models.fec_chain.build_fec — enables the
           LDPC transport-block path (long header, coded frames).
    """
    if cfg.fec and fec is None:
        raise ValueError("cfg.fec=True requires a fec table (fec_chain.build_fec)")
    return {
        "cfg": cfg,
        "alloc": ofdm.build_allocator(cfg),
        "crc_tables": gf2.make_crc_tables(gf2.CRC32_FRAME, cfg.max_frame_bytes()),
        "has_fec": cfg.fec,
        "fec": fec,
    }


def tx_frames(txp, payload: jax.Array, payload_len: jax.Array,
              cnst_id: jax.Array, feedback_cnst: jax.Array,
              frame_no: jax.Array, key: jax.Array,
              fec_feedback: jax.Array | None = None,
              fec_id: jax.Array | None = None) -> TxOut:
    """Modulate a batch of frames.

    Args:
      txp:          from :func:`build_tx` (closed over at trace time).
      payload:      [B, max_frame_bytes] uint8, zero beyond payload_len.
      payload_len:  [B] int32 payload bytes (excl. CRC32). Must satisfy
                    payload_len + 4 <= cfg.frame_bytes(bps(cnst_id)).
      cnst_id:      [B] int32 payload constellation per frame.
      feedback_cnst:[B] int32 echo of the local receiver's MCS request
                    (in-band adaptation, ref packet_header.cc:174-175).
      frame_no:     [B] int32 (12-bit, wraps).
      key:          PRNG key for random padding.
      fec_feedback: [B] int32 echo of the requested FEC scheme (FEC long
                    header only; ref packet_header.cc:113-123 field map,
                    fec_frame_bvb_impl.cc:178-201 switch semantics).
      fec_id:       [B] int32 1-based LDPC code ids (code-bank FEC);
                    announced in the header's fec_scheme field.  None =
                    code 1.
    """
    cfg = txp["cfg"]
    B = payload.shape[0]
    bps = jnp.asarray(cn.BITS_PER_SYMBOL)[cnst_id]
    n_payload_syms = cfg.frame_capacity_symbols

    if txp["has_fec"]:
        # LDPC transport-block path (ref ofdm_adaptive_fec_frame_bvb):
        # one TB fills the frame; long header carries the FEC fields.
        from gr_dtl_jax.models import fec_chain

        frame_bits, tb_payload = fec_chain.fec_frame_build(
            txp["fec"], payload, payload_len, cnst_id, fec_id=fec_id
        )
        frame = repack.bits_to_bytes(frame_bits.astype(jnp.uint8))
        l_total = payload_len + framing.CRC_LEN
        W = txp["fec"]["W"]
        frame_in_tb = jnp.arange(B, dtype=jnp.int32) % W
        frame_bits_n = n_payload_syms * bps.astype(jnp.int32)
        # W == 1: small-TB-in-frame signal (offset == frame payload
        # bits, ref tb_decoder.cc:79-82); W > 1: bit offset of this
        # frame within its TB.  Both clipped to the 12-bit field.
        tb_offset = jnp.where(
            W == 1, frame_bits_n, frame_in_tb * frame_bits_n
        ) & 0xFFF
        fields = header.HeaderFields(
            payload_len=jnp.zeros((B,), jnp.int32),
            frame_no=frame_no,
            cnst_id=cnst_id,
            feedback_cnst=feedback_cnst,
            tb_no=frame_no // W,  # TB (group) number
            fec_feedback=(jnp.zeros((B,), jnp.int32) if fec_feedback is None
                          else fec_feedback.astype(jnp.int32)),
            tb_offset=tb_offset,
            fec_scheme=(jnp.ones((B,), jnp.int32) if fec_id is None
                        else fec_id.astype(jnp.int32)),
            tb_payload=tb_payload,
        )
    else:
        frame, l_total = framing.build_frame_bytes(
            payload, payload_len, key, cfg.max_frame_bytes(), txp["crc_tables"]
        )
        if cfg.scramble_bits:
            # additive scrambler over the framed bytes (ref
            # additive_scrambler_bb 0x8a/0x7f/7, per-frame reset)
            from gr_dtl_jax.ops import scramble

            frame = scramble.scramble_frames(frame)
        fields = header.HeaderFields(
            payload_len=l_total,
            frame_no=frame_no,
            cnst_id=cnst_id,
            feedback_cnst=feedback_cnst,
            tb_no=jnp.zeros((B,), jnp.int32),
            fec_feedback=jnp.zeros((B,), jnp.int32),
            tb_offset=jnp.zeros((B,), jnp.int32),
            fec_scheme=jnp.zeros((B,), jnp.int32),
            tb_payload=jnp.zeros((B,), jnp.int32),
        )

    sym_idx = repack.bytes_to_symbols(frame, bps, n_payload_syms)
    payload_pts = cn.map_symbols(sym_idx, cnst_id[:, None])  # [B, S]
    payload_grid = payload_pts.reshape(B, cfg.frame_length, cfg.n_data_carriers)
    hbits = header.format_header(fields, txp["has_fec"])  # [B, 48*hs]
    # BPSK map: bit b -> points[BPSK][b]
    hpts = cn.map_symbols(
        hbits.astype(jnp.int32),
        jnp.full((B,), int(cn.ConstellationType.BPSK), jnp.int32)[:, None],
    )
    hgrid = hpts.reshape(B, cfg.header_symbols, cfg.n_data_carriers)

    data_syms = jnp.concatenate([hgrid, payload_grid], axis=1)
    spectra = ofdm.allocate_carriers(data_syms, txp["alloc"])  # [B, n_sym, 64]
    time_syms = ofdm.ofdm_modulate(spectra)
    with_cp = ofdm.add_cyclic_prefix(time_syms, cfg.cp_len)
    samples = with_cp.reshape(B, cfg.frame_samples).astype(jnp.complex64)
    return TxOut(samples=samples, frame_bytes=frame, l_total=l_total)
