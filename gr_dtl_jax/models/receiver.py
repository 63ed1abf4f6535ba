"""OFDM receiver chain: baseband samples -> payload bytes + telemetry.

Replaces the reference's RX hierarchy (``python/dtl/ofdm_receiver.py:59-246``:
Schmidl-Cox sync + CFO mixer + trigger repair -> header/payload demux ->
per-path FFT -> chanest -> equalizers -> demap -> unpack) with jitted
batch dataflow:

- the timing metric for the whole sample stream is computed at once
  (cumsum correlator, ops/sync.py) and frames are gathered as aligned
  windows — there is no sample-by-sample state machine;
- header and payload are equalized in two passes of the same
  scan-based equalizer (BPSK first, then the header-announced
  constellation), mirroring the reference's header/payload split;
- everything below frame extraction is a single jitted function over
  the frame batch.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.ops import chanest, constellation as cn
from gr_dtl_jax.ops import equalizer, gf2, header, ofdm, repack, sync
from gr_dtl_jax.models import framing

__all__ = ["build_rx", "rx_frames", "detect_and_extract", "RxOut"]


class RxOut(NamedTuple):
    payload: jax.Array  # [B, max_frame_bytes] uint8, zeroed beyond payload_len
    payload_len: jax.Array  # [B] int32
    crc_ok: jax.Array  # [B] bool payload CRC32
    header_ok: jax.Array  # [B] bool header CRC16
    frame_no: jax.Array  # [B] int32
    cnst_id: jax.Array  # [B] int32 constellation used for the payload
    feedback_cnst: jax.Array  # [B] int32 peer's MCS request (in-band)
    fec_echo: jax.Array  # [B] int32 peer's FEC-scheme request (FEC header)
    snr_db: jax.Array  # [B] float32 payload-equalizer SNR estimate
    noise_var: jax.Array  # [B] float32
    carr_offset: jax.Array  # [B] int32
    soft_syms: jax.Array  # [B, frame_capacity_symbols] equalized payload symbols
    fec_ok: jax.Array  # [B] bool (True when no FEC)
    avg_iters: jax.Array  # [B] float32 mean BP iterations (0 when no FEC)


def build_rx(cfg, fec=None):
    """Precompute RX constants.  Pass ``fec`` (fec_chain.build_fec) to
    enable the LDPC transport-block path."""
    if cfg.fec and fec is None:
        raise ValueError("cfg.fec=True requires a fec table (fec_chain.build_fec)")
    eq = equalizer.build_equalizer(cfg)
    return {
        "cfg": cfg,
        "alloc": ofdm.build_allocator(cfg),
        "ce": chanest.build_chanest(cfg),
        "eq": eq,
        # refinement-pass equalizer: taps start near-true, track slowly
        "eq2": dict(eq, alpha=getattr(cfg, "eq_pass2_alpha", 0.95)),
        "crc_tables": gf2.make_crc_tables(gf2.CRC32_FRAME, cfg.max_frame_bytes()),
        "has_fec": cfg.fec,
        "fec": fec,
    }


def detect_and_extract(stream: jax.Array, cfg, n_frames: int):
    """Schmidl-Cox detection over a contiguous stream -> aligned windows.

    Assumes n_frames frames at the common period cfg.frame_samples with
    an unknown stream offset (the loopback layout, ref
    qa_ofdm_adaptive_txrx.py:49-114).  Returns (frames [n_frames,
    frame_samples], eps [n_frames] fractional CFO).
    """
    P, M = sync.timing_metric(stream, cfg.fft_len)
    phase = sync.fold_detect(M, cfg.frame_samples, cfg.cp_len)
    trig = sync.frame_triggers(M, phase, cfg.frame_samples, n_frames)
    eps = sync.fine_cfo(P, trig, cfg.cp_len, period=cfg.frame_samples)
    # FFT windows start mid-CP: trigger sits on the metric plateau
    # [frame_start, frame_start+cp]; using it directly keeps every
    # 64-sample window inside its own symbol (see ops/sync.py docstring).
    frames = sync.extract_frames(stream, trig, cfg.frame_samples)
    return sync.cfo_correct(frames, eps, cfg.fft_len), eps


def rx_frames(rxp, frames: jax.Array,
              fallback_cnst: jax.Array | None = None,
              defer_fec: bool = False):
    """Demodulate a batch of frame-aligned sample windows.

    Args:
      rxp:    from :func:`build_rx`.
      frames: [B, frame_samples] complex64, aligned so that sample 0 is
              within the first sync symbol's CP (e.g. from
              :func:`detect_and_extract`).
      fallback_cnst: [B] constellation to assume when the header CRC
              fails (the reference keeps its previous d_constellation,
              packet_header.cc:269-273); defaults to BPSK.
      defer_fec: FEC configs only — skip the in-graph transport-block
              decode and return ``(RxOut, fec_in)`` where ``fec_in`` is
              a dict of per-frame FEC decoder inputs (``llrs`` [B,
              max_frame_bits], ``tb_no``/``tb_offset``/``tb_payload``/
              ``fec_id`` [B]) for streaming TB reassembly
              (fec_chain.tb_reassemble).  RxOut.payload/crc_ok are
              placeholders in this mode.
    """
    cfg = rxp["cfg"]
    B = frames.shape[0]
    n_sym = cfg.frame_ofdm_symbols
    sym_len = cfg.symbol_len

    # symbol windows: first 64 of each 80-sample slot (mid-CP alignment)
    wins = frames.reshape(B, n_sym, sym_len)[:, :, : cfg.fft_len]
    spectra = ofdm.ofdm_demodulate(wins)  # [B, n_sym, 64] centered

    carr_off = chanest.estimate_carrier_offset(spectra[:, 0], spectra[:, 1], rxp["ce"])
    spectra = chanest.apply_carrier_shift(spectra, carr_off, rxp["ce"], 0)
    taps0 = chanest.estimate_taps(spectra[:, 0], spectra[:, 1], rxp["ce"])

    hs = cfg.header_symbols
    n_sync = cfg.n_sync_symbols
    occ = jnp.asarray(rxp["alloc"]["occ_idx"])
    hdr_spec = spectra[:, n_sync : n_sync + hs]
    pay_spec = spectra[:, n_sync + hs :]
    bpsk = jnp.full((B,), int(cn.ConstellationType.BPSK), jnp.int32)
    if fallback_cnst is None:
        fallback_cnst = jnp.full((B,), int(cn.ConstellationType.BPSK), jnp.int32)

    # Equalize/parse in 1..eq_passes passes.  Pass 1 works from the
    # 2-sync-symbol LS taps; each further pass re-estimates the taps by
    # LS over EVERY symbol of the frame (known sync words + previous
    # pass's decisions), projects onto the time-limited channel subspace
    # (chanest.denoise_taps), and re-runs header parse + payload
    # equalization with near-true CSI.  All passes are unrolled at trace
    # time — one fused graph, no host round trips.
    eq_passes = max(1, int(getattr(cfg, "eq_passes", 1)))
    taps = taps0
    eq_tab = rxp["eq"]
    active = jnp.asarray(rxp["ce"]["active"])
    sync_refs = jnp.broadcast_to(
        jnp.stack([jnp.asarray(rxp["ce"]["w1"]), jnp.asarray(rxp["ce"]["w2"])]),
        (B, n_sync, cfg.fft_len),
    )
    for p in range(eq_passes):
        # --- header pass (BPSK) ---
        hdr_eq = equalizer.equalize_frame(hdr_spec, taps, bpsk, eq_tab, sym_offset=0)
        hdr_bits = cn.hard_decision(hdr_eq.soft[:, :, occ], bpsk[:, None, None])
        hdr_bits = hdr_bits.reshape(B, hs * cfg.n_data_carriers)
        fields, header_ok = header.parse_header(hdr_bits, rxp["has_fec"])

        # constellation gate: update only on CRC ok and a valid id
        # (ref packet_header.cc:269-273)
        valid_id = (fields.cnst_id >= 1) & (fields.cnst_id <= 4)
        cnst = jnp.where(header_ok & valid_id, fields.cnst_id, fallback_cnst)

        # --- payload pass ---
        pay_eq = equalizer.equalize_frame(
            pay_spec, hdr_eq.taps, cnst, eq_tab, sym_offset=hs
        )
        if p + 1 == eq_passes:
            break
        # data-aided tap re-estimation: per-carrier LS across the whole
        # frame using the decided symbols as references (pilots are the
        # known values already — equalize_frame puts them in .hard)
        refs = jnp.concatenate([sync_refs, hdr_eq.hard, pay_eq.hard], axis=1)
        refs = jnp.where(active[None, None, :], refs, 0.0)
        # residual-CFO repair: a fractional-CFO estimation error rotates
        # symbol s by a common phase ~ s * d (up to ~2 deg/symbol from
        # the Schmidl-Cox plateau average at high SNR), which would
        # decohere an LS average over the frame's symbols.  Estimate the
        # per-symbol drift d from consecutive matched-filter phases and
        # de-rotate the whole frame — a data-aided fine-CFO refinement
        # the reference has no analogue for (its EMA equalizer absorbs
        # the drift instead, at the cost of tap noise).
        z = jnp.sum(spectra * jnp.conj(refs * taps[:, None, :]), axis=-1)
        d = jnp.angle(jnp.sum(z[:, 1:] * jnp.conj(z[:, :-1]), axis=-1))
        srange = jnp.arange(spectra.shape[1], dtype=jnp.float32)
        rot = jnp.exp(-1j * d[:, None] * srange[None, :])
        spectra = spectra * rot[:, :, None]
        hdr_spec = spectra[:, n_sync : n_sync + hs]
        pay_spec = spectra[:, n_sync + hs :]
        num = jnp.sum(spectra * jnp.conj(refs), axis=1)
        den = jnp.sum(jnp.abs(refs) ** 2, axis=1)
        taps = jnp.where(den > 1e-9, num / jnp.maximum(den, 1e-9), 1.0)
        taps = chanest.denoise_taps(taps, rxp["ce"])
        taps = jnp.where(active[None, :], taps, 1.0).astype(jnp.complex64)
        eq_tab = rxp["eq2"]
    soft = pay_eq.soft[:, :, occ].reshape(B, cfg.frame_capacity_symbols)
    bps = jnp.asarray(cn.BITS_PER_SYMBOL)[cnst]

    if rxp["has_fec"]:
        # soft demap -> per-frame LLR bit stream -> TB decode
        # (ref constellation_soft_cf + fec_decoder path)
        from gr_dtl_jax.models import fec_chain

        llr_bits = cn.soft_llrs(soft, cnst[:, None], pay_eq.noise_var[:, None])
        S = cfg.frame_capacity_symbols
        maxF = rxp["fec"]["max_frame_bits"]
        # serialize [B, S, 4] per-symbol LLRs into the frame bit stream:
        # four static-k reshapes + a per-frame select (a dynamic-divisor
        # gather here was one of the coded path's hottest ops)
        llrs = jnp.zeros((B, maxF), llr_bits.dtype)
        for k in (1, 2, 3, 4):
            flat_k = llr_bits[:, :, :k].reshape(B, S * k)
            flat_k = (flat_k[:, :maxF] if S * k >= maxF
                      else jnp.pad(flat_k, ((0, 0), (0, maxF - S * k))))
            llrs = jnp.where((bps == k)[:, None], flat_k, llrs)
        # header-announced TB payload length, gated on header CRC
        default_P = jnp.asarray(rxp["fec"]["tb_payload_tab"])[bps]
        P = jnp.where(header_ok, fields.tb_payload, default_P)
        if defer_fec:
            n_codes = rxp["fec"].get("n_codes", 1)
            fid = jnp.where(
                header_ok & (fields.fec_scheme >= 1)
                & (fields.fec_scheme <= n_codes),
                fields.fec_scheme, 1)
            zeros_b = jnp.zeros((B,), jnp.int32)
            out = RxOut(
                payload=jnp.zeros(
                    (B, rxp["fec"]["max_payload_bytes"]), jnp.uint8),
                payload_len=zeros_b,
                crc_ok=jnp.zeros((B,), bool),
                header_ok=header_ok,
                frame_no=fields.frame_no,
                cnst_id=cnst,
                feedback_cnst=fields.feedback_cnst,
                fec_echo=fields.fec_feedback,
                snr_db=pay_eq.snr_db,
                noise_var=pay_eq.noise_var,
                carr_offset=carr_off,
                soft_syms=soft,
                fec_ok=jnp.zeros((B,), bool),
                avg_iters=jnp.zeros((B,), jnp.float32),
            )
            return out, {"llrs": llrs, "tb_no": fields.tb_no,
                         "tb_offset": fields.tb_offset, "tb_payload": P,
                         "fec_id": fid}
        if rxp["fec"].get("n_codes", 1) > 1:
            # code-bank FEC: the header's fec_scheme field selects the
            # LDPC code per frame (gated on header CRC; default code 1)
            n_codes = rxp["fec"]["n_codes"]
            fid = jnp.where(
                header_ok & (fields.fec_scheme >= 1)
                & (fields.fec_scheme <= n_codes),
                fields.fec_scheme, 1)
            fec_out = fec_chain.fec_frame_decode(
                rxp["fec"], llrs, cnst, P, fec_id=fid)
        else:
            fec_out = fec_chain.fec_frame_decode(rxp["fec"], llrs, cnst, P)
        payload = fec_out.payload
        payload_len = fec_out.payload_len
        crc_ok = fec_out.crc_ok & header_ok
        fec_ok = fec_out.fec_ok
        avg_iters = fec_out.avg_iters
    else:
        dec = cn.hard_decision(soft, cnst[:, None])
        frame_bytes = repack.symbols_to_bytes(dec, bps, cfg.max_frame_bytes())
        if cfg.scramble_bits:
            from gr_dtl_jax.ops import scramble

            frame_bytes = scramble.scramble_frames(frame_bytes)
        payload, payload_len, crc_ok = framing.verify_frame_bytes(
            frame_bytes, fields.payload_len, rxp["crc_tables"]
        )
        crc_ok = crc_ok & header_ok
        fec_ok = jnp.ones((B,), bool)
        avg_iters = jnp.zeros((B,), jnp.float32)

    return RxOut(
        payload=payload,
        payload_len=payload_len,
        crc_ok=crc_ok,
        header_ok=header_ok,
        frame_no=fields.frame_no,
        cnst_id=cnst,
        feedback_cnst=fields.feedback_cnst,
        fec_echo=fields.fec_feedback,
        snr_db=pay_eq.snr_db,
        noise_var=pay_eq.noise_var,
        carr_offset=carr_off,
        soft_syms=soft,
        fec_ok=fec_ok,
        avg_iters=avg_iters,
    )
