"""Channel estimation from the two Schmidl-Cox sync symbols.

Replaces ``digital.ofdm_chanest_vcvc`` (ref ofdm_receiver.py:102-103)
and the carrier-offset de-rotation inside the reference's frame
equalizer (``ofdm_adaptive_frame_equalizer_vcvc_impl.cc:152-177``):

1. coarse *integer* carrier-offset search by correlating the received
   sync spectra against the known sync words over candidate shifts
   (vectorized gather + reduction instead of a per-shift host loop),
2. spectrum de-shift + per-symbol phase ramp for the whole frame,
3. LS channel taps from both sync words on their active carriers.

Sign conventions: a residual time-domain CFO of +n0 subcarriers makes
the received spectrum appear at index c + n0; de-shifting gathers
``y[k + n0]``.  Because OFDM symbol s's FFT window starts 80 s samples
into the frame, the same CFO adds a common phase
``exp(+2i pi n0 cp_len s / fft_len)`` to symbol s, removed by the ramp.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "PRECISION",
    "build_chanest",
    "estimate_carrier_offset",
    "apply_carrier_shift",
    "estimate_taps",
    "denoise_taps",
]


# the projection, offset search and one-hot shift are small GEMMs whose
# TF32 rounding (DEFAULT on the GPU) sits ~60 dB below the signal
PRECISION = jax.lax.Precision.DEFAULT


def _time_support_projection(active_idx: np.ndarray, fft_len: int,
                             support: int) -> np.ndarray:
    """LS projection onto frequency responses of time-limited channels.

    The taps seen by the equalizer are H[c] = sum_t g[t] e^{-2i pi c t/N}
    with the impulse response g supported on t in [0, support): the FFT
    window starts at the head of the cyclic prefix, so a flat channel is
    a pure delay of cp_len and any physical delay spread <= cp_len keeps
    the support below 2*cp_len+1.  Projecting the raw per-carrier LS
    estimate onto that |S|-dimensional subspace cuts the estimation
    noise by n_active/|S| (~2 dB here) at zero bias — a per-frame
    replacement for averaging taps over many frames.

    Returns P [n_active, n_active] with denoised = P @ h_active.
    """
    c = active_idx.astype(np.float64) - fft_len // 2
    t = np.arange(support, dtype=np.float64)
    A = np.exp(-2j * np.pi * np.outer(c, t) / fft_len)
    P = A @ np.linalg.pinv(A)
    return P.astype(np.complex64)


def build_chanest(cfg, max_carr_offset: int = 6):
    half = cfg.fft_len // 2
    w1 = cfg.sync_word1()
    w2 = cfg.sync_word2()
    active = np.zeros(cfg.fft_len, dtype=bool)
    for c in list(cfg.occupied_carriers) + list(cfg.pilot_carriers):
        active[c + half] = True
    active_idx = np.nonzero(active)[0].astype(np.int32)
    support = 2 * cfg.cp_len + 1
    return {
        "w1": w1,
        "w2": w2,
        "active": active,
        "active_idx": active_idx,
        "proj": _time_support_projection(active_idx, cfg.fft_len, support),
        "max_off": max_carr_offset,
        "fft_len": cfg.fft_len,
        "cp_len": cfg.cp_len,
    }


def denoise_taps(taps: jax.Array, ce) -> jax.Array:
    """Project per-carrier taps onto the time-limited channel subspace.

    Args:
      taps: [..., fft_len] complex taps (1.0 fill on inactive carriers).
    Returns same shape; active carriers denoised, others untouched.
    """
    idx = jnp.asarray(ce["active_idx"])
    proj = jnp.asarray(ce["proj"])
    ha = taps[..., idx]  # [..., n_active]
    hd = jnp.matmul(ha, proj.T, precision=PRECISION)
    return taps.at[..., idx].set(hd)


def _shifted_const(y: np.ndarray, off: int) -> np.ndarray:
    """Static-shift helper for host constants: out[k] = y[k+off], zeroed
    outside — the trace-time form of a per-frame shifted gather, so the
    device graphs need none."""
    n = y.shape[-1]
    out = np.zeros_like(y)
    lo, hi = max(0, -off), min(n, n - off)
    out[..., lo:hi] = y[..., lo + off : hi + off]
    return out


def estimate_carrier_offset(y1: jax.Array, y2: jax.Array, ce) -> jax.Array:
    """Integer carrier offset n0 per frame.

    Args:
      y1, y2: [B, fft_len] received centered spectra of the sync symbols.
    Returns [B] int32: the spectrum is found at carrier c + n0.
    """
    w1 = np.asarray(ce["w1"])
    w2 = np.asarray(ce["w2"])
    offs = jnp.arange(-ce["max_off"], ce["max_off"] + 1, dtype=jnp.int32)

    # Differential correlation: a timing offset of d samples multiplies
    # carrier k by exp(-2i pi k d / N), which would destroy a plain
    # correlation against the known word.  Correlating *carrier pair
    # products* y[k] conj(y[k+s]) against w[k] conj(w[k+s]) cancels that
    # ramp (the product's phase is a constant), leaving a sharp peak at
    # the true integer offset — same trick as the reference's chanest.
    #
    # All candidate shifts at once as ONE matmul against a precomputed
    # [n_off, fft] shifted-reference table: sum_k dy[k+off] conj(dw[k])
    # == sum_k' dy[k'] conj(dw[k'-off]) with the same edge terms zeroed
    # either way — the per-offset shifted-data gather becomes a GEMM.
    def dy_of(y, step):
        return y * jnp.conj(jnp.roll(y, -step, axis=-1))

    def table(w, step):
        dw = w * np.conj(np.roll(w, -step, axis=-1))
        return np.stack([_shifted_const(dw, -int(o))
                         for o in range(-ce["max_off"], ce["max_off"] + 1)])

    W1 = jnp.asarray(np.conj(table(w1, 2)))   # [n_off, fft]
    W2 = jnp.asarray(np.conj(table(w2, 1)))
    scores = (jnp.abs(jnp.matmul(dy_of(y1, 2), W1.T, precision=PRECISION))
              + jnp.abs(jnp.matmul(dy_of(y2, 1), W2.T,
                                   precision=PRECISION)))  # [B, n_off]
    return offs[jnp.argmax(scores, axis=-1)].astype(jnp.int32)


def apply_carrier_shift(spectra: jax.Array, carr_offset: jax.Array,
                        ce, first_sym_index: int = 0) -> jax.Array:
    """Undo integer carrier offset on [B, n_sym, fft_len] spectra.

    De-shift by n0 carriers and remove the per-symbol common phase
    (see module docstring).  ``first_sym_index`` is the absolute index
    within the frame (sync symbols included) of ``spectra[:, 0]``.

    The per-frame shift is a batched matmul against a per-frame shift
    matrix selected by one-hot from 2*max_off+1 constant matrices —
    the [B, n_sym, fft] arbitrary gather this replaces was the hottest
    op left in the demod chain.
    """
    n_sym = spectra.shape[1]
    n = spectra.shape[-1]
    n_off = 2 * ce["max_off"] + 1
    # SHIFT[o, k, l] = 1 iff out[l] = y[k] for offset o, i.e. k = l + off
    eye = np.eye(n, dtype=np.float32)
    SHIFT = np.stack([_shifted_const(eye, -int(o)).T
                      for o in range(-ce["max_off"], ce["max_off"] + 1)])
    oneh = jax.nn.one_hot(carr_offset + ce["max_off"], n_off,
                          dtype=jnp.float32)                 # [B, n_off]
    M = jnp.einsum("bo,okl->bkl", oneh, jnp.asarray(SHIFT),
                   precision=PRECISION)                      # [B, n, n]
    shifted = jnp.einsum("bsk,bkl->bsl", spectra, M.astype(spectra.dtype),
                         precision=PRECISION)
    s = jnp.arange(n_sym, dtype=jnp.float32) + jnp.float32(first_sym_index)
    ph = (
        -2.0 * jnp.pi * carr_offset[:, None].astype(jnp.float32)
        * ce["cp_len"] * s[None, :] / ce["fft_len"]
    )
    return shifted * jnp.exp(1j * ph)[..., None]


def estimate_taps(y1c: jax.Array, y2c: jax.Array, ce,
                  denoise: bool = True) -> jax.Array:
    """LS channel taps from offset-corrected sync spectra.

    Returns [B, fft_len] complex64; 1.0 on inactive carriers so later
    divisions stay benign.  ``denoise`` projects the estimate onto the
    time-limited channel subspace (see :func:`denoise_taps`).
    """
    w1 = jnp.asarray(ce["w1"])
    w2 = jnp.asarray(ce["w2"])
    active = jnp.asarray(ce["active"])
    w1_nz = jnp.abs(w1) > 0
    h2 = y2c / jnp.where(jnp.abs(w2) > 0, w2, 1.0)
    h1 = y1c / jnp.where(w1_nz, w1, 1.0)
    taps = jnp.where(w1_nz[None, :], 0.5 * (h1 + h2), h2)
    taps = jnp.where(active[None, :], taps, 1.0)
    if denoise:
        taps = denoise_taps(taps, ce)
        taps = jnp.where(active[None, :], taps, 1.0)
    return taps.astype(jnp.complex64)
