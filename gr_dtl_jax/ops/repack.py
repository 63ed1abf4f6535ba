"""Bit repacking: bytes <-> k-bit symbols, LSB-first, batched and adaptive.

Design note
-----------
The reference keeps a *stateful* bit repacker carrying partial-byte
indexes across streaming work calls (``lib/testbed/repack.cc:31-112``).
In the frame-batched dataflow repacking is stateless by construction:
every frame owns a whole number of symbols, and the bits-per-symbol
``k`` may differ per frame (adaptive MCS).  The variable-``k`` repack is
a single gather over an unpacked bit tensor — static shapes, no
branches, uniform across a mixed batch.

Bit order matches the reference's LSB-first convention
(``repack.cc:48-67``): symbol ``s`` of a frame takes bits
``s*k .. s*k+k-1`` of the byte stream, each byte contributing its LSB
first; bit ``j`` of a symbol is bit ``s*k+j`` of the stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "bytes_to_bits",
    "bits_to_bytes",
    "bytes_to_symbols",
    "symbols_to_bytes",
]


def bytes_to_bits(data: jax.Array) -> jax.Array:
    """[.., N] uint8 -> [.., N*8] bits (LSB of each byte first)."""
    bits = (data[..., None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes(bits: jax.Array) -> jax.Array:
    """[.., N*8] bits -> [.., N] uint8 (LSB-first within each byte)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).astype(jnp.uint8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
    return jnp.sum(b * weights, axis=-1, dtype=jnp.uint8)


def bytes_to_symbols(data: jax.Array, bps: jax.Array, n_symbols: int) -> jax.Array:
    """Repack bytes into k-bit symbols with per-frame k.

    The per-frame ``k`` is handled by computing all four STATIC-``k``
    repacks (each a free reshape + shift) and selecting per frame —
    dynamic-divisor index math would lower to a per-element gather.

    Args:
      data:      [B, max_bytes] uint8.
      bps:       [B] int32 bits per symbol (1..4); symbols beyond the
                 byte buffer are 0 (callers size max_bytes >=
                 n_symbols*max_bps/8 to avoid truncation).
      n_symbols: static symbol count per frame.
    Returns [B, n_symbols] int32 symbol indices.
    """
    bits = bytes_to_bits(data).astype(jnp.int32)  # [B, max_bits]
    B, max_bits = bits.shape
    out = jnp.zeros((B, n_symbols), jnp.int32)
    weights = jnp.int32(1) << jnp.arange(4, dtype=jnp.int32)
    for k in (1, 2, 3, 4):
        need = n_symbols * k
        bk = bits[:, :need] if need <= max_bits else jnp.pad(
            bits, ((0, 0), (0, need - max_bits)))
        sym_k = jnp.sum(bk.reshape(B, n_symbols, k) * weights[:k], axis=-1,
                        dtype=jnp.int32)
        out = jnp.where((bps == k)[:, None], sym_k, out)
    return out


def symbols_to_bytes(symbols: jax.Array, bps: jax.Array, max_bytes: int) -> jax.Array:
    """Inverse of :func:`bytes_to_symbols` (same static-``k`` + select
    design: four static repacks + a select instead of a ``t // k``
    per-frame-divisor gather).

    Args:
      symbols:  [B, n_symbols] int32.
      bps:      [B] int32 bits per symbol.
      max_bytes: static output byte count (bits beyond n_symbols*bps are 0).
    Returns [B, max_bytes] uint8.
    """
    B, S = symbols.shape
    T = max_bytes * 8
    out_bits = jnp.zeros((B, T), jnp.int32)
    for k in (1, 2, 3, 4):
        bits_k = (symbols[:, :, None] >> jnp.arange(k, dtype=jnp.int32)) & 1
        flat = bits_k.reshape(B, S * k)
        flat = (flat[:, :T] if S * k >= T
                else jnp.pad(flat, ((0, 0), (0, T - S * k))))
        out_bits = jnp.where((bps == k)[:, None], flat, out_bits)
    return bits_to_bytes(out_bits)
