"""Frame payload building/unpacking: CRC32 append/verify + random padding.

Mirrors the reference TX framer's no-FEC path
(``ofdm_adaptive_frame_bb_impl.cc:139-173``: payload | CRC32 | random
padding up to the frame's byte capacity at the current bps) and the RX
unpacker (``ofdm_adaptive_frame_pack_bb_impl.cc:73-123``: repack, CRC32
verify over the header-announced payload length).  The reference does
this per frame on the host; here a batch of frames is built/verified
with vectorized selects and the affine CRC (ops/gf2).

The header's payload-length field counts payload + CRC bytes
(ref frame_bb_impl.cc:343).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gr_dtl_jax.ops import gf2

__all__ = ["build_frame_bytes", "verify_frame_bytes", "CRC_LEN"]

CRC_LEN = 4  # CRC32


def _crc_bytes(crc: jax.Array) -> jax.Array:
    """[B] uint32 -> [B, 4] little-endian bytes (ref crc_util.cc:34-36
    appends byte i = crc >> 8i)."""
    shifts = jnp.arange(CRC_LEN, dtype=jnp.uint32) * 8
    return ((crc[:, None] >> shifts) & 0xFF).astype(jnp.uint8)


def build_frame_bytes(payload: jax.Array, payload_len: jax.Array,
                      key: jax.Array, max_frame_bytes: int,
                      crc_tables) -> tuple[jax.Array, jax.Array]:
    """Assemble frame byte buffers: payload | CRC32 | random pad.

    Args:
      payload:     [B, max_payload] uint8, rows zero beyond payload_len.
      payload_len: [B] int32 payload bytes (excl. CRC).
      key:         PRNG key for the random padding (ref rand_pad,
                   frame_bb_impl.cc:355-364).
      max_frame_bytes: static buffer size (capacity at max bps).
      crc_tables:  gf2.make_crc_tables(CRC32_FRAME, max_payload).
    Returns:
      frame:   [B, max_frame_bytes] uint8.
      l_total: [B] int32 = payload_len + 4 (the header length field).
    """
    B = payload.shape[0]
    j = jnp.arange(max_frame_bytes, dtype=jnp.int32)[None, :]
    L = payload_len[:, None]
    pay = jnp.pad(payload, ((0, 0), (0, max(0, max_frame_bytes - payload.shape[1]))))[
        :, :max_frame_bytes
    ]
    pay = jnp.where(j < L, pay, 0)  # the affine CRC needs zeros beyond L
    crc = gf2.crc_device(pay, payload_len, crc_tables)
    # crc byte for position j is byte (j - L): extract by dynamic shift
    # (pure ALU — a take_along_axis here is a per-element gather)
    sh = (jnp.clip(j - L, 0, CRC_LEN - 1) * 8).astype(jnp.uint32)
    crc_at_j = ((crc[:, None] >> sh) & 0xFF).astype(jnp.uint8)
    rand = jax.random.randint(key, (B, max_frame_bytes), 0, 256, dtype=jnp.int32).astype(
        jnp.uint8
    )
    frame = jnp.where(j < L, pay, jnp.where(j < L + CRC_LEN, crc_at_j, rand))
    return frame, payload_len + CRC_LEN


def verify_frame_bytes(frame: jax.Array, l_total: jax.Array,
                       crc_tables) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Check the frame CRC and return the clean payload.

    Args:
      frame:   [B, max_frame_bytes] uint8 received frame buffers.
      l_total: [B] int32 header length field (payload + 4).
    Returns (payload [B, max_frame_bytes] uint8 zero-masked beyond its
    length, payload_len [B] int32, crc_ok [B] bool).
    """
    max_frame_bytes = frame.shape[1]
    payload_len = jnp.clip(l_total - CRC_LEN, 0, max_frame_bytes - CRC_LEN)
    j = jnp.arange(max_frame_bytes, dtype=jnp.int32)[None, :]
    L = payload_len[:, None]
    payload = jnp.where(j < L, frame, 0)
    crc = gf2.crc_device(payload, payload_len, crc_tables)
    sh = (jnp.clip(j - L, 0, CRC_LEN - 1) * 8).astype(jnp.uint32)
    crc_at_j = ((crc[:, None] >> sh) & 0xFF).astype(jnp.uint8)
    got_at_j = jnp.where((j >= L) & (j < L + CRC_LEN), frame, 0)
    want_at_j = jnp.where((j >= L) & (j < L + CRC_LEN), crc_at_j, 0)
    crc_ok = jnp.all(got_at_j == want_at_j, axis=1) & (l_total >= CRC_LEN)
    return payload, payload_len, crc_ok
