"""Pilot-aided decision-directed equalizer + per-frame SNR estimation.

Design note
-----------
The reference equalizes carrier-by-carrier in a nested host loop with
per-carrier EMA channel updates (``ofdm_adaptive_equalizer.cc:217-268``)
and a streaming SNR estimator reset per frame.  The update is
decision-directed, hence inherently sequential *across OFDM symbols*,
but every carrier is independent — so here it is a ``lax.scan`` over
the frame's symbols with all carriers (and the whole frame batch)
vectorized: 20 scan steps over [B, 64] arrays, with no per-carrier
control flow (masks select pilot/data/idle
carriers).

Semantics mirror the reference exactly:
 - taps update ``H = alpha*H + (1-alpha) * Y/ref`` with ``ref`` the
   known pilot value on pilot carriers and the *decided* symbol on data
   carriers (the reference hardcodes alpha = 0.1, ofdm_receiver.py:115,
   i.e. 90% weight on the noisy NEW estimate; we default to the
   config's eq_alpha = 0.8 which measurably beats it on static
   channels — set eq_alpha=0.1 for exact reference behavior),
 - hard output = decided symbols, soft output = pre-decision equalized
   symbols (ref equalizer.cc:250-260),
 - SNR from the equalized pilots.  Deviation from the reference: gr's
   ``mpsk_snr_est_simple`` (y1=E|x|, y2=E|x|^2, snr=y1^2/(y2-y1^2))
   measures only the *amplitude* component of the pilot error, which
   under-counts the noise by ~2x (phase noise is invisible to |x|) and
   over-reads SNR by ~3 dB once the channel taps are accurate.  Here
   the noise is the full complex pilot error E|eqd - pilot|^2 — the
   honest per-carrier noise variance, which is also exactly the sigma^2
   the soft demapper's max-log metric needs (ops/constellation.soft_llrs).
   The reference's bias was historically masked by its own tap noise;
   with this framework's denoised/refined taps the honest estimator is
   the one that keeps the MCS ladder thresholds meaning "true SNR in dB".
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.ops import constellation as cn

__all__ = ["build_equalizer", "equalize_frame", "EqualizerOut"]


class EqualizerOut(NamedTuple):
    hard: jax.Array  # [B, n_sym, fft_len] decided symbols (pilots replaced by known values)
    soft: jax.Array  # [B, n_sym, fft_len] pre-decision equalized symbols
    taps: jax.Array  # [B, fft_len] final channel state
    snr_db: jax.Array  # [B] estimated SNR (dB) from pilots
    noise_var: jax.Array  # [B] linear noise variance estimate


def build_equalizer(cfg):
    """Precompute pilot layout constants.

    pilot_vals[s, k]: known pilot value for data-symbol s (0 = header),
    matching the allocator's scrambled pilot sets
    (ops/ofdm.build_allocator; ref ofdm_adaptive_config.py:33-36 and
    equalizer pilot-set loading equalizer.cc:196-213).
    """
    fft_len = cfg.fft_len
    half = fft_len // 2
    occ = np.zeros(fft_len, dtype=bool)
    for c in cfg.occupied_carriers:
        occ[c + half] = True
    pil = np.zeros(fft_len, dtype=bool)
    pil_idx = np.array(cfg.pilot_carriers, dtype=np.int32) + half
    pil[pil_idx] = True

    # reuse the allocator's pilot map (single source of truth for the
    # scrambled pilot pattern — TX pilots and the equalizer's expected
    # pilots can never diverge)
    from gr_dtl_jax.ops import ofdm

    pilot_map = ofdm.build_allocator(cfg)["pilot_map"]
    pilot_vals = np.where(pil[None, :], pilot_map[cfg.n_sync_symbols :], 0.0).astype(
        np.complex64
    )

    return {
        "occ_mask": occ,
        "pilot_mask": pil,
        "pilot_vals": pilot_vals,
        "alpha": getattr(cfg, "eq_alpha", 0.1),
        "header_syms": cfg.header_symbols,
    }


def equalize_frame(spectra: jax.Array, init_taps: jax.Array,
                   cnst_id: jax.Array, eq, sym_offset: int = 0) -> EqualizerOut:
    """Equalize the data symbols of a batch of frames.

    Args:
      spectra:   [B, n_data_syms, fft_len] offset-corrected spectra
                 (header symbol(s) first, then payload).
      init_taps: [B, fft_len] from chanest.
      cnst_id:   [B] payload constellation id; the header symbol(s) use
                 BPSK regardless (ref header equalizer fixed BPSK,
                 equalizer.cc:161-174). Header symbol count is inferred
                 from eq["pilot_vals"] rows vs payload rows at trace
                 time via the header_syms argument baked in eq.
      eq:        from :func:`build_equalizer`.
      sym_offset: absolute data-symbol index of spectra[:, 0] (0 = the
                 first header symbol) — selects the right pilot sets
                 when header and payload are equalized in two passes
                 (the payload pass passes sym_offset=header_symbols,
                 mirroring the reference's symbols_skipped,
                 ofdm_receiver.py:163).
    """
    B, n_sym, fft_len = spectra.shape
    occ = jnp.asarray(eq["occ_mask"])
    pil = jnp.asarray(eq["pilot_mask"])
    pilot_vals = jnp.asarray(eq["pilot_vals"])  # [n_sym, fft]
    alpha = eq["alpha"]

    # per-symbol constellation: header rows use BPSK, payload rows the
    # frame's adaptive constellation
    header_syms = eq.get("header_syms", 1)
    abs_idx = jnp.arange(n_sym) + sym_offset
    sym_cnst = jnp.where(
        (abs_idx < header_syms)[None, :],
        jnp.int32(cn.ConstellationType.BPSK),
        cnst_id[:, None].astype(jnp.int32),
    )  # [B, n_sym]

    if float(alpha) >= 0.9995:
        # frozen-taps fast path: with alpha ~= 1 the decision-directed
        # update is a no-op, the symbol recurrence disappears, and the
        # whole frame equalizes as one vectorized op instead of a
        # 20+-step scan (bit-exact vs the scan at alpha == 1 since H
        # never changes).  Measured opt-in, NOT the pass-2 default:
        # freezing pass-2 taps doubles QAM16 BER at 23 dB because the
        # slow DD tracking absorbs residual per-symbol drift
        # (examples/eq_pass2_alpha_ablation.json) — set
        # cfg.eq_pass2_alpha = 1.0 only when trading that dB fraction
        # for throughput.
        pv = pilot_vals[sym_offset : sym_offset + n_sym][None]  # [1,S,fft]
        eqd = spectra / init_taps[:, None, :]
        _, dec = cn.nearest_point(eqd, sym_cnst[:, :, None])
        hard = jnp.where(pil[None, None, :], pv, dec)
        err = jnp.where(pil[None, None, :], eqd - pv, 0.0)
        n_pilots = jnp.sum(pil)
        tot = n_sym * n_pilots
        noise_var = jnp.maximum(
            jnp.sum(jnp.abs(err) ** 2, axis=(1, 2)) / tot, 1e-12)
        sig_scalar = jnp.maximum(
            jnp.sum(jnp.where(pil[None, None, :],
                              jnp.abs(pv) ** 2, 0.0)) / tot, 1e-12)
        sig_pw = jnp.broadcast_to(sig_scalar, noise_var.shape)
        snr_db = 10.0 * jnp.log10(sig_pw / noise_var)
        return EqualizerOut(
            hard=hard, soft=eqd, taps=init_taps,
            snr_db=snr_db.astype(jnp.float32),
            noise_var=noise_var.astype(jnp.float32),
        )

    def step(H, xs):
        Y, pv, cid = xs  # Y: [B, fft], pv: [fft], cid: [B]
        eqd = Y / H  # [B, fft]
        # data-carrier decision (vectorized nearest point, mixed batch)
        _, dec = cn.nearest_point(eqd, cid[:, None])
        ref = jnp.where(pil[None, :], pv[None, :], dec)
        ref_safe = jnp.where(jnp.abs(ref) > 0, ref, 1.0)
        H_new = alpha * H + (1.0 - alpha) * Y / ref_safe
        upd = (occ | pil)[None, :]
        H = jnp.where(upd, H_new, H)
        hard = jnp.where(pil[None, :], pv[None, :], dec)
        # pilot error statistics for SNR: full complex error of the
        # pre-update equalized pilots vs the known pilot values
        err = jnp.where(pil[None, :], eqd - pv[None, :], 0.0)
        p_e2 = jnp.sum(jnp.abs(err) ** 2, axis=-1)
        p_s2 = jnp.sum(jnp.where(pil[None, :], jnp.abs(pv[None, :]) ** 2, 0.0),
                       axis=-1)
        return H, (hard, eqd, p_e2, p_s2)

    xs = (
        jnp.moveaxis(spectra, 1, 0),  # [n_sym, B, fft]
        pilot_vals[sym_offset : sym_offset + n_sym],
        jnp.moveaxis(sym_cnst, 1, 0),  # [n_sym, B]
    )
    # unroll: same math, 4 symbols per compiled loop iteration — the
    # per-step tensors are tiny ([B, 64]), so loop overhead is a real
    # fraction of the scan's cost on the sequential DD chain
    H_final, (hard, soft, p_e2, p_s2) = jax.lax.scan(step, init_taps, xs,
                                                     unroll=4)

    n_pilots = jnp.sum(pil)
    tot = n_sym * n_pilots
    noise_var = jnp.maximum(jnp.sum(p_e2, axis=0) / tot, 1e-12)
    sig_pw = jnp.maximum(jnp.sum(p_s2, axis=0) / tot, 1e-12)
    snr_db = 10.0 * jnp.log10(sig_pw / noise_var)

    return EqualizerOut(
        hard=jnp.moveaxis(hard, 0, 1),
        soft=jnp.moveaxis(soft, 0, 1),
        taps=H_final,
        snr_db=snr_db.astype(jnp.float32),
        noise_var=noise_var.astype(jnp.float32),
    )
