"""FEC transport-block framing: LDPC-coded frames with shortening.

Mirrors the reference's FEC path (SURVEY.md #2, #15, #17-20):
TX ``ofdm_adaptive_fec_frame_bvb`` + ``tb_encoder`` and RX
``ofdm_adaptive_fec_decoder`` + ``tb_decoder``, with the same transport
math:

- codewords per TB: ``ncws = 1 + frame_bits // n`` when the frame is
  larger than one codeword (``fec_utils.cc:104-112``),
- the TB payload is split over codewords with balanced shortening
  ``k'_i = ceil(remaining / cw_left)`` (``tb_encoder.cc:48-52``), which
  has the closed form ``k'_i = ceil((P - i) / ncws)`` used here,
- each codeword is transmitted as ``[ncheck check bits | k'_i
  systematic bits]`` (``tb_encoder.cc:65-70``); shortened systematic
  bits are never sent and are pinned at +SHORTENED_LLR on decode
  (``tb_decoder.cc:143-165``),
- the TB payload carries a CRC32 like the no-FEC framer.

Design note
-----------
The reference reassembles TBs across frames with a stateful byte-offset
state machine (``tb_decoder.cc:32-141``).  Here the transport block is
sized to *exactly fill one frame* (the reference's "small TB
exclusively transported by the frame" case, ``tb_decoder.cc:79-92``),
so a batch of frames is a batch of independent TBs: every per-frame
quantity (bps, ncws, k' schedule, offsets) is computed vectorized, the
codeword tensor has static shape ``[B, max_ncws, n]`` (unused trailing
codewords of low-bps frames are masked dummies), and one batched BP
call decodes everything.  No sequential reassembly state exists to
carry — which is what lets the whole FEC path live inside a single
jitted graph.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

import os

from gr_dtl_jax.ops import constellation as cn
from gr_dtl_jax.ops import gf2, ldpc, repack

# Bank-decoder form switch: banks up to this many codes take the dense
# matmul-form BP (n_codes x redundant FLOPs), larger banks the gather
# form.  The crossover on the GPU is not measured
# (tools/bench_bank_switch.py measures it); any bank the reference
# ships (1-3 codes, ldpc_enc.cc:21-30) is far below the default.
# Override per deployment via env.
BANK_MM_MAX_CODES = int(os.environ.get("GR_DTL_BANK_MM_MAX", "32"))

__all__ = ["build_fec", "fec_frame_build", "fec_frame_decode", "FecFrameOut",
           "TbRing", "init_tb_state", "tb_reassemble", "decode_emitted"]

CRC_LEN_BITS = 32


class FecFrameOut(NamedTuple):
    payload: jax.Array  # [B, max_payload_bytes] decoded user bytes
    payload_len: jax.Array  # [B] int32 user bytes
    crc_ok: jax.Array  # [B] bool
    fec_ok: jax.Array  # [B] bool all real codewords converged
    avg_iters: jax.Array  # [B] float32 mean BP iterations over real cws
    tb_payload_len: jax.Array  # [B] bits


def build_fec(cfg, H, tb_frames: int = 1):
    """Precompute FEC-chain constants for a config + parity matrix(es).

    Args:
      H: one parity-check matrix, or a list of them — a **code bank**
        mirroring the reference's 1-indexed encoder/decoder vector
        (``ldpc_enc.cc:21-30``); per-frame ``fec_id`` then selects the
        code inside the jitted graph (the reference switches codes per
        TB from the MCS/feedback, fec_frame_bvb_impl.cc:178-201).
        Single-H tables are the bank's code 1, so all single-code call
        sites keep working unchanged.
      tb_frames: frames per transport block (W).  W = 1 reproduces the
        reference's small-TB-per-frame case; W > 1 gives the reference's
        multi-frame TBs (tb_decoder.cc reassembly across frames), here
        with TBs aligned to W-frame groups so the whole group decodes in
        one static-shape batch.  All tables below are *group*-level.
    """
    Hs = H if isinstance(H, (list, tuple)) else [H]
    bank = ldpc.build_ldpc_bank([np.asarray(h) for h in Hs])
    C = bank["n_codes"]
    cap_syms = cfg.frame_capacity_symbols
    W = int(tb_frames)
    max_frame_bits = cap_syms * cn.MAX_BPS
    max_group_bits = W * max_frame_bits

    # per-(code, bps) static tables; frame_bits per single frame,
    # everything else per W-frame group
    frame_bits_tab = np.array([0] + [cap_syms * b for b in range(1, 5)], np.int32)
    group_bits_tab = W * frame_bits_tab
    ncws_tab2 = np.zeros((C + 1, 5), np.int32)
    tb_payload_tab2 = np.zeros((C + 1, 5), np.int32)
    user_bytes_tab2 = np.zeros((C + 1, 5), np.int32)
    for ci in range(1, C + 1):
        n_c = int(bank["n_tab"][ci])
        m_c = int(bank["m_tab"][ci])
        ncws_tab2[ci, 0] = 1
        for b in range(1, 5):
            gb = int(group_bits_tab[b])
            ncws = 1 + gb // n_c if gb > n_c else 1
            # user payload bits: what's left after check bits,
            # byte-aligned, minus the CRC32
            avail = gb - ncws * m_c
            user_bytes = avail // 8 - CRC_LEN_BITS // 8
            assert user_bytes > 0, "frame group too small for this code"
            ncws_tab2[ci, b] = ncws
            user_bytes_tab2[ci, b] = user_bytes
            tb_payload_tab2[ci, b] = user_bytes * 8 + CRC_LEN_BITS
    ncws_tab2[0] = ncws_tab2[1]
    tb_payload_tab2[0] = tb_payload_tab2[1]
    user_bytes_tab2[0] = user_bytes_tab2[1]

    max_ncws = int(ncws_tab2.max())
    max_payload_bytes = int(user_bytes_tab2.max())
    code = bank["codes"][0]
    return {
        "cfg": cfg,
        "bank": bank,
        "n_codes": C,
        # legacy single-code views (= code 1) keep existing call sites
        # and the fec_id=None paths working unchanged
        "code": code,
        "n": code["N"], "k": code["K"], "m": code["M"],
        "W": W,
        "max_ncws": max_ncws,
        "frame_bits_tab": frame_bits_tab,
        "group_bits_tab": group_bits_tab,
        "ncws_tab": ncws_tab2[1],
        "tb_payload_tab": tb_payload_tab2[1],
        "user_bytes_tab": user_bytes_tab2[1],
        "ncws_tab2": ncws_tab2,
        "tb_payload_tab2": tb_payload_tab2,
        "user_bytes_tab2": user_bytes_tab2,
        "max_payload_bytes": max_payload_bytes,
        "max_frame_bits": max_frame_bits,
        "max_group_bits": max_group_bits,
        "crc_tables": gf2.make_crc_tables(
            gf2.CRC32_FRAME, max_payload_bytes + CRC_LEN_BITS // 8
        ),
    }


class TbRing(NamedTuple):
    """In-progress transport-block buffer for streaming reassembly —
    the reference tb_decoder's RCV_BUF state (``tb_decoder.cc:26-66``)
    as a scan carry: one TB under assembly, keyed by the header's
    ``tb_no``, slots addressed by the header's ``tb_offset``."""

    tb_no: jax.Array  # int32 scalar, -1 = nothing buffered yet
    llrs: jax.Array  # [W, max_frame_bits] float32 per-slot LLRs
    present: jax.Array  # [W] bool slot-received mask
    cnst: jax.Array  # int32 TB constellation
    plen: jax.Array  # int32 TB payload bits (header fec_tb_payload)
    fec_id: jax.Array  # int32 1-based LDPC code id


def init_tb_state(fec) -> TbRing:
    W, maxF = fec["W"], fec["max_frame_bits"]
    return TbRing(
        tb_no=jnp.asarray(-1, jnp.int32),
        llrs=jnp.zeros((W, maxF), jnp.float32),
        present=jnp.zeros((W,), bool),
        cnst=jnp.asarray(1, jnp.int32),
        plen=jnp.asarray(0, jnp.int32),
        fec_id=jnp.asarray(1, jnp.int32),
    )


def tb_reassemble(state: TbRing, llrs: jax.Array, tb_no: jax.Array,
                  tb_offset: jax.Array, cnst_id: jax.Array,
                  tb_payload: jax.Array, fec_id: jax.Array,
                  ok: jax.Array, fec):
    """Loss-resilient streaming TB reassembly keyed by the header fields.

    The reference's ``tb_decoder::process_frame`` accumulates frames
    into a TB buffer keyed by ``tb_no`` and re-anchors on the tag's
    offset after a lost frame (``tb_decoder.cc:90-138``).  Here the same
    re-anchoring runs as a ``lax.scan`` over a batch of received frames
    in stream order: every header-valid frame writes its LLRs into the
    slot ``tb_offset // frame_bits`` of the buffer for its ``tb_no``; a
    frame announcing a NEW tb_no emits the previous buffer (slots never
    received stay at LLR 0 = erasure, which BP can often still decode —
    the reference simply drops incomplete TBs).  Header-invalid frames
    change nothing, so a lost/corrupted frame only erases its own slot
    and every later TB stays aligned.

    Args:
      state: TbRing carry from the previous batch.
      llrs:  [F, max_frame_bits] per-frame LLR streams in stream order.
      tb_no/tb_offset/cnst_id/tb_payload/fec_id: [F] header fields.
      ok:    [F] bool — header CRC ok (gates everything).
    Returns (state', emitted) with emitted a dict of [F]-leading arrays:
      llrs [F, W, maxF], cnst/plen/fec_id/tb_no [F], valid [F] (True
      where a finished TB was emitted at this scan position).
    """
    W = fec["W"]
    fb_tab = jnp.asarray(fec["frame_bits_tab"])
    bps_tab = jnp.asarray(cn.BITS_PER_SYMBOL)

    def step(st: TbRing, x):
        llr_i, tb_i, off_i, cn_i, pl_i, fid_i, ok_i = x
        is_new = ok_i & (tb_i != st.tb_no)
        emit = is_new & (st.tb_no >= 0)
        emitted = (st.llrs, st.cnst, st.plen, st.fec_id, st.tb_no, emit)
        # start a fresh buffer on a new tb_no (erase stale slots)
        buf = jnp.where(is_new, 0.0, st.llrs)
        pres = jnp.where(is_new, False, st.present)
        tbno = jnp.where(is_new, tb_i, st.tb_no)
        cnst = jnp.where(is_new, cn_i, st.cnst)
        plen = jnp.where(is_new, pl_i, st.plen)
        fid = jnp.where(is_new, fid_i, st.fec_id)
        # slot from the announced offset (ref tb_decoder.cc:110-133);
        # W == 1 uses the offset==frame_bits sentinel (ref :79-82)
        fb = fb_tab[bps_tab[jnp.clip(cn_i, 0, 4)]]
        slot = jnp.clip(off_i // jnp.maximum(fb, 1), 0, W - 1)
        slot = jnp.where(W == 1, 0, slot)
        write = ok_i & (tb_i == tbno)
        buf = buf.at[slot].set(jnp.where(write, llr_i, buf[slot]))
        pres = pres.at[slot].set(write | pres[slot])
        return TbRing(tbno, buf, pres, cnst, plen, fid), emitted

    state, (e_llrs, e_cnst, e_plen, e_fid, e_tbno, e_valid) = jax.lax.scan(
        step, state,
        (llrs, tb_no.astype(jnp.int32), tb_offset.astype(jnp.int32),
         cnst_id.astype(jnp.int32), tb_payload.astype(jnp.int32),
         fec_id.astype(jnp.int32), ok),
    )
    return state, {"llrs": e_llrs, "cnst": e_cnst, "plen": e_plen,
                   "fec_id": e_fid, "tb_no": e_tbno, "valid": e_valid}


def decode_emitted(fec, emitted) -> FecFrameOut:
    """Decode reassembled TB buffers from :func:`tb_reassemble`.

    Rows where ``emitted['valid']`` is False are decoded as dummies and
    must be masked by the caller.  Returns TB-level outputs (one row per
    emitted slot, NOT per frame).
    """
    F, W, maxF = emitted["llrs"].shape
    llrs = emitted["llrs"].reshape(F * W, maxF)
    rep = lambda a: jnp.repeat(jnp.clip(a, 1, None), W)
    fid = rep(emitted["fec_id"]) if fec.get("n_codes", 1) > 1 else None
    out = fec_frame_decode(
        fec, llrs, rep(emitted["cnst"]),
        jnp.repeat(jnp.maximum(emitted["plen"], CRC_LEN_BITS + 8), W),
        fec_id=fid,
    )
    # fec_frame_decode returns per-frame rows (W per TB, payload on the
    # first); compact back to one row per TB
    take = slice(None, None, W)
    return FecFrameOut(
        payload=out.payload[take],
        payload_len=out.payload_len[take],
        crc_ok=out.crc_ok[take] & emitted["valid"],
        fec_ok=out.fec_ok[take],
        avg_iters=out.avg_iters[take],
        tb_payload_len=out.tb_payload_len[take],
    )


def _gather_slices(rows: jax.Array, starts: jax.Array, length: int) -> jax.Array:
    """rows [G, T], starts [G, C] -> [G, C, length] contiguous windows
    (slice gather; rows right-padded so short tail windows never shift)."""
    def per_row(row, st):
        row = jnp.pad(row, (0, length))
        st = jnp.clip(st, 0, row.shape[-1] - length)
        return jax.vmap(
            lambda s: jax.lax.dynamic_slice(row, (s,), (length,)))(st)

    return jax.vmap(per_row)(rows, starts)


def _cw_schedule(fec, bps: jax.Array, fec_id: jax.Array | None = None):
    """Vectorized per-frame codeword schedule.

    Args:
      bps: [B] int32.
      fec_id: optional [B] 1-based code ids (code bank); None = code 1.
    Returns dict of [B, max_ncws] arrays: k_prime, cw_start (bit offset
    of each codeword in the frame), sys_start (bit offset of each cw's
    systematic bits within the TB payload), real (mask of actual cws);
    plus per-frame scalars m ([B] check bits) and ncws/payload_bits.
    """
    if fec_id is None:
        m = jnp.full(bps.shape, fec["m"], jnp.int32)
        ncws = jnp.asarray(fec["ncws_tab"])[bps]  # [B]
        P = jnp.asarray(fec["tb_payload_tab"])[bps]  # [B] payload bits
    else:
        m = jnp.asarray(fec["bank"]["m_tab"])[fec_id]
        ncws = jnp.asarray(fec["ncws_tab2"])[fec_id, bps]
        P = jnp.asarray(fec["tb_payload_tab2"])[fec_id, bps]
    i = jnp.arange(fec["max_ncws"], dtype=jnp.int32)[None, :]  # [1, C]
    real = i < ncws[:, None]
    # balanced shortening, closed form of tb_encoder.cc:48-52
    k_prime = jnp.where(real, (P[:, None] - i + ncws[:, None] - 1) // ncws[:, None], 0)
    sys_start = jnp.cumsum(k_prime, axis=1) - k_prime
    cw_len = jnp.where(real, k_prime + m[:, None], 0)
    cw_start = jnp.cumsum(cw_len, axis=1) - cw_len
    return {"k_prime": k_prime, "cw_start": cw_start, "sys_start": sys_start,
            "real": real, "ncws": ncws, "payload_bits": P, "m": m}


def _static_schedule(fec, bps: int, fec_idx: int | None = None):
    """Host-side (numpy) codeword schedule for one (bps, code) pair —
    the same closed forms as :func:`_cw_schedule`, but with Python ints
    so the resulting gather indices are compile-time constants."""
    Cmax = fec["max_ncws"]
    if fec_idx is None:
        m = int(fec["m"])
        ncws = int(fec["ncws_tab"][bps])
        P = int(fec["tb_payload_tab"][bps])
    else:
        m = int(fec["bank"]["m_tab"][fec_idx])
        ncws = int(fec["ncws_tab2"][fec_idx, bps])
        P = int(fec["tb_payload_tab2"][fec_idx, bps])
    i = np.arange(Cmax, dtype=np.int32)
    real = i < ncws
    k_prime = np.where(real, (P - i + ncws - 1) // max(ncws, 1), 0).astype(np.int32)
    sys_start = np.cumsum(k_prime) - k_prime
    cw_len = np.where(real, k_prime + m, 0)
    cw_start = (np.cumsum(cw_len) - cw_len).astype(np.int32)
    return {"k_prime": k_prime, "cw_start": cw_start,
            "sys_start": sys_start.astype(np.int32), "real": real,
            "payload_bits": P, "m": m, "ncws": ncws}


def fec_frame_build(fec, payload: jax.Array, payload_len: jax.Array,
                    cnst_id: jax.Array, fec_id: jax.Array | None = None):
    """TX: user bytes -> frame bit stream (LDPC-coded, shortened).

    Args:
      payload:     [B, max_payload_bytes] uint8 user data (zero beyond
                   payload_len); the frame is always filled to capacity
                   (short payloads are zero-padded before the CRC, so
                   payload_len must equal user_bytes_tab[bps] for full
                   frames — partial fills carry zeros, like the
                   reference's PDU padding).
      payload_len: [B] int32 user bytes.
      cnst_id:     [B] constellation -> bps.  With W = tb_frames > 1,
                   rows are grouped W at a time: the group payload comes
                   from row g*W (other rows ignored) and the group's
                   constellation from cnst_id[g*W] (must be uniform
                   within a group, like the reference which switches
                   MCS only between TBs).
      fec_id:      optional [B] 1-based code ids into the fec bank —
                   per-frame code selection inside the jitted graph
                   (ref fec_frame_bvb_impl.cc:178-201).  None = code 1
                   via the (cheaper) shared-constant path.
    Returns (frame_bits [B, max_frame_bits] int32, tb_payload_len [B]).
    """
    code = fec["code"]
    W = fec["W"]
    B = payload.shape[0]
    assert B % W == 0, "batch must be a multiple of tb_frames"
    if W > 1:
        payload = payload[::W]
        payload_len = payload_len[::W]
        cnst_id = cnst_id[::W]
        if fec_id is not None:
            fec_id = fec_id[::W]
        B = payload.shape[0]  # group count from here on
    m, k, n = fec["m"], fec["k"], fec["n"]
    bps = jnp.asarray(cn.BITS_PER_SYMBOL)[cnst_id]
    sched = _cw_schedule(fec, bps, fec_id)

    # TB payload bits: [payload bytes | crc32], LSB-first bit order
    pay_padded = jnp.pad(
        payload, ((0, 0), (0, CRC_LEN_BITS // 8))  # match crc_tables width
    )
    crc = gf2.crc_device(pay_padded, payload_len, fec["crc_tables"])
    pay_bits = repack.bytes_to_bits(payload)  # [B, maxpay*8]
    maxP = fec["max_payload_bytes"] * 8 + CRC_LEN_BITS
    x = jnp.arange(maxP, dtype=jnp.int32)[None, :]
    Lbits = payload_len[:, None] * 8
    # crc bit (x - Lbits) by dynamic shift (no per-element gather)
    crc_at_x = ((crc[:, None] >> jnp.clip(x - Lbits, 0, 31).astype(jnp.uint32))
                & 1).astype(jnp.int32)
    tb_bits = jnp.where(
        x < Lbits,
        jnp.pad(pay_bits, ((0, 0), (0, maxP - pay_bits.shape[1])))[:, :maxP],
        jnp.where(x < Lbits + 32, crc_at_x, 0),
    ).astype(jnp.int32)

    Cmax = fec["max_ncws"]
    if fec_id is None:
        # per-cw systematic messages [B, C, K]
        t = jnp.arange(k, dtype=jnp.int32)[None, None, :]
        sys_idx = jnp.clip(sched["sys_start"][:, :, None] + t, 0, maxP - 1)
        msgs = jnp.take_along_axis(
            tb_bits[:, None, :].repeat(Cmax, axis=1).reshape(B * Cmax, maxP),
            sys_idx.reshape(B * Cmax, k),
            axis=1,
        ).reshape(B, Cmax, k)
        msgs = jnp.where(t < sched["k_prime"][:, :, None], msgs, 0)

        cws = ldpc.encode(msgs.reshape(-1, k).astype(jnp.float32), code)
        cws = cws.reshape(B, Cmax, n)
        tx_cws = cws  # already in [check | systematic] tx layout
        n_tx = n
        m_col = m
    else:
        # bank path: padded cw layout [parity: Mmax | sys: Kmax]
        bank = fec["bank"]
        Kmax, Mmax, Nmax = bank["Kmax"], bank["Mmax"], bank["Nmax"]
        t = jnp.arange(Kmax, dtype=jnp.int32)[None, None, :]
        sys_idx = jnp.clip(sched["sys_start"][:, :, None] + t, 0, maxP - 1)
        msgs = jnp.take_along_axis(
            tb_bits[:, None, :].repeat(Cmax, axis=1).reshape(B * Cmax, maxP),
            sys_idx.reshape(B * Cmax, Kmax),
            axis=1,
        ).reshape(B, Cmax, Kmax)
        msgs = jnp.where(t < sched["k_prime"][:, :, None], msgs, 0)
        code_idx = jnp.repeat(fec_id, Cmax)
        cws = ldpc.encode_bank(msgs.reshape(-1, Kmax), code_idx, bank)
        cws = cws.reshape(B, Cmax, Nmax)
        # reorder to the transmitted [m_b checks | k' systematic] view:
        # tx bit j <- padded slot (j if j < m_b else Mmax + j - m_b)
        n_tx = Nmax
        jj = jnp.arange(Nmax, dtype=jnp.int32)[None, None, :]
        m_b = sched["m"][:, None, None]
        src = jnp.where(jj < m_b, jj, jnp.clip(Mmax + jj - m_b, 0, Nmax - 1))
        tx_cws = jnp.take_along_axis(
            cws.reshape(B * Cmax, Nmax),
            jnp.broadcast_to(src, (B, Cmax, Nmax)).reshape(B * Cmax, Nmax),
            axis=1,
        ).reshape(B, Cmax, Nmax)
        m_col = sched["m"][:, None, None]

    # scatter transmitted bits [ncheck | k'] into the group bit stream
    G = payload.shape[0]
    j = jnp.arange(n_tx, dtype=jnp.int32)[None, None, :]
    send = (j < m_col + sched["k_prime"][:, :, None]) & sched["real"][:, :, None]
    pos = sched["cw_start"][:, :, None] + j
    maxG = fec["max_group_bits"]
    pos = jnp.where(send, pos, maxG)  # parked slot dropped below
    group_bits = jnp.zeros((G, maxG + 1), jnp.int32)
    group_bits = group_bits.at[
        jnp.arange(G)[:, None, None], pos
    ].set(tx_cws)
    group_bits = group_bits[:, :maxG]
    # the header's fec_tb_payload field carries the ACTUAL payload bits
    # (user bytes + CRC32) so partially filled frames decode correctly;
    # the codeword schedule itself always uses the full-capacity layout
    actual_tb = payload_len * 8 + CRC_LEN_BITS
    if W == 1:
        return group_bits, actual_tb
    # split the group stream into W per-frame streams: frame f of group
    # g carries group bits [f*fb, (f+1)*fb) with fb = cap*bps (dynamic)
    maxF = fec["max_frame_bits"]
    fb = jnp.asarray(fec["frame_bits_tab"])[bps]  # [G]
    f = jnp.arange(W, dtype=jnp.int32)[None, :, None]
    x = jnp.arange(maxF, dtype=jnp.int32)[None, None, :]
    src = f * fb[:, None, None] + x
    ok = jnp.broadcast_to(x < fb[:, None, None], (G, W, maxF))
    src = jnp.clip(src, 0, maxG - 1)
    frame_bits = jnp.take_along_axis(
        group_bits[:, None, :].repeat(W, axis=1).reshape(G * W, maxG),
        src.reshape(G * W, maxF), axis=1)
    frame_bits = jnp.where(ok.reshape(G * W, maxF), frame_bits, 0)
    tb_payload = jnp.repeat(actual_tb, W)
    return frame_bits, tb_payload


def fec_frame_decode(fec, llrs: jax.Array, cnst_id: jax.Array,
                     tb_payload_len: jax.Array | None = None,
                     fec_id: jax.Array | None = None) -> FecFrameOut:
    """RX: per-frame LLR stream -> decoded user bytes.

    Args:
      llrs:    [B, max_frame_bits] float32 LLRs in frame bit order
               (LLR > 0 <=> bit 0); entries beyond the frame's real bit
               count are ignored.
      cnst_id: [B] constellation used by each frame.
      tb_payload_len: [B] bits from the header's fec_tb_payload field;
               defaults to the full-frame value for the bps.
      fec_id:  optional [B] 1-based code ids (from the header's
               fec_scheme field); None = code 1.
    """
    code = fec["code"]
    W = fec["W"]
    B = llrs.shape[0]
    assert B % W == 0, "batch must be a multiple of tb_frames"
    if fec_id is not None and W > 1:
        fec_id = fec_id[::W]
    if W > 1:
        # reassemble group LLR streams from W consecutive frames
        # (the reference's tb_decoder RCV_BUF accumulation across
        # frames, tb_decoder.cc:57-66, as one static gather)
        G = B // W
        cnst_id = cnst_id[::W]
        bps_g = jnp.asarray(cn.BITS_PER_SYMBOL)[cnst_id]  # [G]
        fb = jnp.asarray(fec["frame_bits_tab"])[bps_g]
        maxG = fec["max_group_bits"]
        maxF = llrs.shape[1]
        y = jnp.arange(maxG, dtype=jnp.int32)[None, :]
        f = jnp.clip(y // jnp.maximum(fb[:, None], 1), 0, W - 1)
        x = y - f * fb[:, None]
        ok = y < W * fb[:, None]
        llrs_f = llrs.reshape(G, W, maxF)
        src = jnp.clip(f * maxF + x, 0, W * maxF - 1)
        group_llrs = jnp.take_along_axis(llrs_f.reshape(G, W * maxF), src, axis=1)
        llrs = jnp.where(ok, group_llrs, 0.0)
        if tb_payload_len is not None:
            tb_payload_len = tb_payload_len[::W]
    m, k, n = fec["m"], fec["k"], fec["n"]
    bps = jnp.asarray(cn.BITS_PER_SYMBOL)[cnst_id]
    sched = _cw_schedule(fec, bps, fec_id)
    Cmax = fec["max_ncws"]

    G = llrs.shape[0]  # groups (== B when W == 1)

    if fec_id is None:
        # With a single code the codeword layout is a function of bps
        # alone (4 possible values) and every codeword is a CONTIGUOUS
        # run of the frame bit stream — so the extraction is Cmax
        # *static slices* stacked per bps variant, plus a 4-way select
        # instead of one [G, C*n] take_along_axis gather; slices +
        # selects are bandwidth-only.
        #
        # sent is ALSO masked by `real`: fake codewords (c >= ncws_b)
        # previously kept `j < m` "sent" and gathered garbage LLRs from
        # beyond the frame's real bits, which could never satisfy the
        # syndrome — silently defeating the decoders' batch-wide early
        # exit for every mixed/padded batch.  Pinned fully at
        # +SHORTENED_LLR they decode as the all-zeros codeword at the
        # first syndrome check.
        maxF = llrs.shape[1]
        jj = np.arange(n, dtype=np.int32)[None, :]
        # pad right by n so the LAST codeword's full-width slice never
        # clips: its sent region (j < m + k') always lies inside the
        # real maxF bits, and the padded tail is overwritten with
        # +SHORTENED_LLR by the sent mask (a start clamp instead would
        # SHIFT the slice and misalign the last codeword at max bps)
        llrs_p = jnp.pad(llrs, ((0, 0), (0, n)))
        variants = []
        for kb in range(1, 5):
            s = _static_schedule(fec, kb)
            sls = []
            for c in range(Cmax):
                st = int(min(max(s["cw_start"][c], 0), maxF))
                sls.append(jax.lax.slice_in_dim(llrs_p, st, st + n, axis=1))
            v = jnp.stack(sls, axis=1)  # [G, Cmax, n]
            sent = (jj < m + s["k_prime"][:, None]) & s["real"][:, None]
            variants.append(jnp.where(jnp.asarray(sent), v,
                                      ldpc.SHORTENED_LLR))
        cw_llrs = jnp.select(
            [(bps == kb)[:, None, None] for kb in (1, 2, 3)],
            variants[:3], variants[3])

        bits, iters, ok = ldpc.decode_mm(
            cw_llrs.reshape(-1, n).astype(jnp.float32), code, max_iters=15
        )
        bits = bits.reshape(G, Cmax, n)
        sys_bits = bits[:, :, m:]  # [G, C, k]
        k_sys = k
    else:
        # bank path: padded layout [parity: Mmax | sys: Kmax].  Padded
        # slot p maps to frame bit cw_start + p (parity, sent iff
        # p < m_b) or cw_start + m_b + (p - Mmax) (systematic, sent iff
        # p - Mmax < k'); everything unsent is pinned shortened.
        bank = fec["bank"]
        Kmax, Mmax, Nmax = bank["Kmax"], bank["Mmax"], bank["Nmax"]
        p = jnp.arange(Nmax, dtype=jnp.int32)[None, None, :]
        m_b = sched["m"][:, None, None]
        kp = sched["k_prime"][:, :, None]
        is_par = p < Mmax
        tsys = p - Mmax
        sent = jnp.where(is_par, p < m_b, tsys < kp) & sched["real"][:, :, None]
        off = sched["cw_start"][:, :, None] + jnp.where(is_par, p, m_b + tsys)
        pos = jnp.clip(off, 0, llrs.shape[1] - 1)
        # fold the codeword axis into the gather index instead of
        # materializing a [G, Cmax, maxF] repeat of the LLR rows
        cw_llrs = jnp.take_along_axis(
            llrs, pos.reshape(G, Cmax * Nmax), axis=1).reshape(G, Cmax, Nmax)
        cw_llrs = jnp.where(sent, cw_llrs, ldpc.SHORTENED_LLR)

        code_idx = jnp.repeat(fec_id, Cmax)
        # banks up to BANK_MM_MAX_CODES take the dense matmul-form
        # decoder, beyond it the bank-size-invariant gather form
        dec = (ldpc.decode_bank_mm if bank["n_codes"] <= BANK_MM_MAX_CODES
               else ldpc.decode_bank)
        bits, iters, ok = dec(
            cw_llrs.reshape(-1, Nmax).astype(jnp.float32), code_idx, bank,
            max_iters=15)
        bits = bits.reshape(G, Cmax, Nmax)
        sys_bits = bits[:, :, Mmax:]  # [G, C, Kmax]
        k_sys = Kmax
    iters = iters.reshape(G, Cmax)
    ok = ok.reshape(G, Cmax)

    real = sched["real"]
    fec_ok = jnp.all(ok | ~real, axis=1)
    n_real = jnp.sum(real, axis=1)
    avg_iters = jnp.sum(jnp.where(real, iters, 0), axis=1) / jnp.maximum(n_real, 1)

    # reassemble TB payload bits from systematic parts
    maxP = fec["max_payload_bytes"] * 8 + CRC_LEN_BITS
    if fec_id is None:
        # same static-slice trick as the extraction above: payload bits
        # are contiguous within each codeword's k' systematic segment,
        # so the inverse map is a per-bps concatenation of static
        # slices + zero pad instead of a [G, maxP] element gather)
        variants = []
        for kb in range(1, 5):
            s = _static_schedule(fec, kb)
            segs = [sys_bits[:, c, : int(s["k_prime"][c])]
                    for c in range(Cmax) if s["k_prime"][c] > 0]
            seg = (jnp.concatenate(segs, axis=1) if segs
                   else jnp.zeros((G, 0), sys_bits.dtype))
            if seg.shape[1] < maxP:
                seg = jnp.pad(seg, ((0, 0), (0, maxP - seg.shape[1])))
            variants.append(seg[:, :maxP])
        tb_bits = jnp.select([(bps == kb)[:, None] for kb in (1, 2, 3)],
                             variants[:3], variants[3])
    else:
        t = jnp.arange(k_sys, dtype=jnp.int32)[None, None, :]
        take = (t < sched["k_prime"][:, :, None]) & real[:, :, None]
        dst = jnp.where(take, sched["sys_start"][:, :, None] + t, maxP)
        tb_bits = jnp.zeros((G, maxP + 1), jnp.int32)
        tb_bits = tb_bits.at[jnp.arange(G)[:, None, None], dst].set(sys_bits)
        tb_bits = tb_bits[:, :maxP]

    P = tb_payload_len if tb_payload_len is not None else sched["payload_bits"]
    user_bytes = (P - CRC_LEN_BITS) // 8
    all_bytes = repack.bits_to_bytes(tb_bits)  # [B, maxP/8]
    xb = jnp.arange(all_bytes.shape[1], dtype=jnp.int32)[None, :]
    payload = jnp.where(xb < user_bytes[:, None], all_bytes, 0)
    crc = gf2.crc_device(payload, user_bytes, fec["crc_tables"])
    # received crc: 4 bytes at user_bytes offset, extracted by shift
    sh = (jnp.clip(xb - user_bytes[:, None], 0, 3) * 8).astype(jnp.uint32)
    want = jnp.where(
        (xb >= user_bytes[:, None]) & (xb < user_bytes[:, None] + 4),
        ((crc[:, None] >> sh) & 0xFF).astype(jnp.uint8), 0,
    )
    got = jnp.where(
        (xb >= user_bytes[:, None]) & (xb < user_bytes[:, None] + 4), all_bytes, 0
    )
    crc_ok = jnp.all(got == want, axis=1)

    out = FecFrameOut(
        payload=payload[:, : fec["max_payload_bytes"]],
        payload_len=user_bytes,
        crc_ok=crc_ok & fec_ok,
        fec_ok=fec_ok,
        avg_iters=avg_iters.astype(jnp.float32),
        tb_payload_len=P,
    )
    if W == 1:
        return out
    # expand to per-frame rows: the group's payload is attributed to its
    # first frame; the remaining W-1 rows carry zero-length payloads but
    # replicate the status flags (so frame-level stats stay sensible)
    first = (jnp.arange(B) % W) == 0
    rep = lambda a: jnp.repeat(a, W, axis=0)
    return FecFrameOut(
        payload=jnp.where(first[:, None], rep(out.payload), 0),
        payload_len=jnp.where(first, rep(out.payload_len), 0),
        crc_ok=rep(out.crc_ok),
        fec_ok=rep(out.fec_ok),
        avg_iters=rep(out.avg_iters),
        tb_payload_len=rep(out.tb_payload_len),
    )
