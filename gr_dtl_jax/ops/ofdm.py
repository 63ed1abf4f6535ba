"""OFDM modulation core: DFT, carrier allocation, cyclic prefix.

Design note
-----------
The reference runs per-symbol FFTs through FFTW and a streaming
carrier-allocator block (``digital.ofdm_carrier_allocator_cvc``,
``fft.fft_vcc``, ``digital.ofdm_cyclic_prefixer`` — ref
python/dtl/ofdm_transmitter.py:166-186).  Here the whole frame batch is
one tensor ``[B, n_sym, fft_len]`` and the size-64 (I)DFT is a complex
matrix multiply against a precomputed twiddle matrix (batched
[B*n_sym, 64] x [64, 64]), one library GEMM instead of many small FFTs.  Carrier allocation is a static
scatter (one gather per frame batch), pilots are a precomputed
``[n_sym, fft_len]`` constant added in.

Conventions: frequency-domain vectors are *centered* (carrier c lives
at index c + fft_len/2); transforms are unitary (norm="ortho") so
power is preserved through mod/demod and the equalizer sees unit-gain
channels for an identity channel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "DFT_PRECISION",
    "dft_matrix",
    "ofdm_modulate",
    "ofdm_demodulate",
    "build_allocator",
    "allocate_carriers",
    "extract_carriers",
    "add_cyclic_prefix",
    "remove_cyclic_prefix",
]


# float32 GEMMs on the GPU run in TF32 at DEFAULT precision (about three
# decimal digits); the DFT's error budget is checked against a float64
# FFT on the card by chip_smoke.py's reference phase
DFT_PRECISION = jax.lax.Precision.DEFAULT


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int, inverse: bool) -> np.ndarray:
    """Unitary (I)DFT matrix, with fftshift folded in.

    Forward maps centered-spectrum -> nothing; we fold the shift so that
    ``time = x @ dft_matrix(n, inverse=True)`` takes a *centered*
    frequency vector to time samples, and ``freq = y @ dft_matrix(n,
    False)`` returns a centered spectrum.
    """
    k = np.arange(n)
    # centered bin for row/col index i is i - n/2
    kc = k - n // 2
    if inverse:
        # time[t] = (1/sqrt(n)) sum_c X[c] exp(+2i pi (c) t / n), c centered
        m = np.exp(2j * np.pi * np.outer(kc, k) / n) / np.sqrt(n)
    else:
        # X[c] = (1/sqrt(n)) sum_t y[t] exp(-2i pi c t / n)
        m = np.exp(-2j * np.pi * np.outer(k, kc) / n) / np.sqrt(n)
    return m.astype(np.complex64)


def ofdm_modulate(freq: jax.Array) -> jax.Array:
    """[..., fft_len] centered spectrum -> [..., fft_len] time samples."""
    n = freq.shape[-1]
    return jnp.matmul(freq, jnp.asarray(dft_matrix(n, inverse=True)),
                      precision=DFT_PRECISION)


def ofdm_demodulate(time: jax.Array) -> jax.Array:
    """[..., fft_len] time samples -> [..., fft_len] centered spectrum."""
    n = time.shape[-1]
    return jnp.matmul(time, jnp.asarray(dft_matrix(n, inverse=False)),
                      precision=DFT_PRECISION)


def build_allocator(cfg):
    """Precompute allocation constants for a config.

    Returns dict with:
      data_idx   [frame_length+hdr, n_data] int32 — centered FFT index of
                 each data/header slot, per OFDM symbol (same each sym).
      pilot_map  [n_total_syms, fft_len] complex64 — pilot values (incl.
                 zeros elsewhere); row 0..1 are the sync words, then
                 header + payload symbols with the scrambled pilot sets
                 (ref digital.ofdm_carrier_allocator_cvc + config
                 pilot_symbols = (x,x,x,-x) per scramble-seq entry,
                 ofdm_adaptive_config.py:33-36).
    """
    fft_len = cfg.fft_len
    half = fft_len // 2
    occ = np.array(cfg.occupied_carriers, dtype=np.int32) + half
    pil = np.array(cfg.pilot_carriers, dtype=np.int32) + half
    n_sym = cfg.frame_ofdm_symbols
    n_data_syms = cfg.header_symbols + cfg.frame_length

    pilot_map = np.zeros((n_sym, fft_len), dtype=np.complex64)
    pilot_map[0] = cfg.sync_word1()
    pilot_map[1] = cfg.sync_word2()
    seq = np.array(cfg.pilot_sym_scramble_seq, dtype=np.float32)
    for s in range(n_data_syms):
        x = seq[s % len(seq)]
        vals = np.array([x, x, x, -x], dtype=np.complex64)
        pilot_map[cfg.n_sync_symbols + s, pil] = vals

    return {
        "occ_idx": occ,
        "pilot_idx": pil,
        "pilot_map": pilot_map,
        "n_data_syms": n_data_syms,
    }


def allocate_carriers(data_syms: jax.Array, alloc) -> jax.Array:
    """Place header+payload symbols and pilots/sync into the frame grid.

    Args:
      data_syms: [B, n_data_syms, n_data_carriers] complex modulated
                 symbols (header symbol(s) first, then payload rows).
      alloc:     from :func:`build_allocator`.
    Returns [B, n_total_syms, fft_len] centered spectra.
    """
    B = data_syms.shape[0]
    pilot_map = jnp.asarray(alloc["pilot_map"])  # [n_sym, fft]
    n_sym, fft_len = pilot_map.shape
    occ = jnp.asarray(alloc["occ_idx"])
    grid = jnp.broadcast_to(pilot_map, (B, n_sym, fft_len))
    n_sync = n_sym - data_syms.shape[1]
    # scatter data symbols into occupied carriers of symbols n_sync..
    upd = grid[:, n_sync:, :].at[:, :, occ].set(data_syms)
    return jnp.concatenate([grid[:, :n_sync, :], upd], axis=1)


def extract_carriers(spectra: jax.Array, alloc) -> jax.Array:
    """Inverse of allocate: gather occupied-carrier values of data symbols.

    Args:
      spectra: [B, n_data_syms, fft_len] (sync symbols already removed).
    Returns [B, n_data_syms, n_data_carriers].
    """
    occ = jnp.asarray(alloc["occ_idx"])
    return spectra[:, :, occ]


def add_cyclic_prefix(time_syms: jax.Array, cp_len: int) -> jax.Array:
    """[..., n_sym, fft_len] -> [..., n_sym, cp+fft] (ref
    digital.ofdm_cyclic_prefixer, rolloff 0)."""
    cp = time_syms[..., -cp_len:]
    return jnp.concatenate([cp, time_syms], axis=-1)


def remove_cyclic_prefix(samples: jax.Array, fft_len: int, cp_len: int) -> jax.Array:
    """[..., n_sym, cp+fft] -> [..., n_sym, fft_len] (drop the prefix)."""
    return samples[..., cp_len:]
