"""Frame header formatter/parser (batched, in-graph).

Bit layout mirrors the reference exactly
(``lib/dtl/ofdm_adaptive_packet_header.cc:166-199,231-312``):

short header (48 bits, 1 BPSK OFDM symbol):
  bits  0-11  payload length in bytes (incl. CRC32), LSB-first
  bits 12-23  frame number (mod 4096)
  bits 24-27  constellation id
  bits 28-31  feedback constellation id (in-band adaptation echo)
  bits 32-47  CRC16 over bits 0-31 (packed MSB-first into 4 bytes;
              poly 0x1021 init 0xFFFF, result reflected), CRC value
              inserted LSB-first

long header with FEC (96 bits, 2 BPSK OFDM symbols) adds at bit 32
(ref packet_header.cc:113-123):
  bits 32-43  TB number
  bits 44-47  FEC feedback scheme
  bits 48-59  TB offset
  bits 60-63  FEC scheme
  bits 64-79  TB payload length
  bits 80-95  CRC16 over bits 0-79 (packed MSB-first into 10 bytes)

The reference computes these per frame on the host; here a whole batch
is formatted/parsed with vectorized bit ops and the shared affine-CRC
(ops/gf2) — header processing stays inside the jitted chain.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gr_dtl_jax.ops import gf2

__all__ = ["HeaderFields", "format_header", "parse_header", "header_nbits"]


class HeaderFields(NamedTuple):
    payload_len: jax.Array  # [B] int32: bytes incl. CRC32
    frame_no: jax.Array  # [B] int32 (12 bit)
    cnst_id: jax.Array  # [B] int32 (4 bit)
    feedback_cnst: jax.Array  # [B] int32 (4 bit)
    # FEC fields (zeros for the short header)
    tb_no: jax.Array
    fec_feedback: jax.Array
    tb_offset: jax.Array
    fec_scheme: jax.Array
    tb_payload: jax.Array


def header_nbits(has_fec: bool) -> int:
    return 96 if has_fec else 48


def _field_bits(val: jax.Array, nbits: int) -> jax.Array:
    """[B] -> [B, nbits] LSB-first bits."""
    return (val[:, None] >> jnp.arange(nbits, dtype=jnp.int32)) & 1


def _bits_to_field(bits: jax.Array) -> jax.Array:
    """[B, nbits] -> [B] int32, LSB-first."""
    w = jnp.int32(1) << jnp.arange(bits.shape[-1], dtype=jnp.int32)
    return jnp.sum(bits.astype(jnp.int32) * w, axis=-1)


def _crc16_of_bits(bits: jax.Array, n_msg_bits: int) -> jax.Array:
    """CRC16 over the first n_msg_bits, packed MSB-first into bytes
    (ref pack_crc, packet_header.cc:93-105)."""
    n_bytes = n_msg_bits // 8
    b = bits[:, :n_msg_bits].reshape(bits.shape[0], n_bytes, 8)
    w = jnp.int32(1) << jnp.arange(7, -1, -1, dtype=jnp.int32)
    msg = jnp.sum(b.astype(jnp.int32) * w, axis=-1).astype(jnp.uint8)
    tables = gf2.make_crc_tables(gf2.CRC16_HEADER, n_bytes)
    lengths = jnp.full((bits.shape[0],), n_bytes, dtype=jnp.int32)
    return gf2.crc_device(msg, lengths, tables).astype(jnp.int32)


def format_header(fields: HeaderFields, has_fec: bool) -> jax.Array:
    """Build header bits. Returns [B, header_nbits] int32 bits (0/1)."""
    parts = [
        _field_bits(fields.payload_len & 0xFFF, 12),
        _field_bits(fields.frame_no & 0xFFF, 12),
        _field_bits(fields.cnst_id & 0xF, 4),
        _field_bits(fields.feedback_cnst & 0xF, 4),
    ]
    if has_fec:
        parts += [
            _field_bits(fields.tb_no & 0xFFF, 12),
            _field_bits(fields.fec_feedback & 0xF, 4),
            _field_bits(fields.tb_offset & 0xFFF, 12),
            _field_bits(fields.fec_scheme & 0xF, 4),
            _field_bits(fields.tb_payload & 0xFFFF, 16),
        ]
    msg = jnp.concatenate(parts, axis=-1)
    crc = _crc16_of_bits(msg, msg.shape[-1])
    return jnp.concatenate([msg, _field_bits(crc, 16)], axis=-1)


def parse_header(bits: jax.Array, has_fec: bool) -> tuple[HeaderFields, jax.Array]:
    """Parse header bits -> (fields, crc_ok[B] bool)."""
    B = bits.shape[0]
    bits = bits.astype(jnp.int32)
    z = jnp.zeros((B,), jnp.int32)
    payload_len = _bits_to_field(bits[:, 0:12])
    frame_no = _bits_to_field(bits[:, 12:24])
    cnst_id = _bits_to_field(bits[:, 24:28])
    feedback_cnst = _bits_to_field(bits[:, 28:32])
    if has_fec:
        tb_no = _bits_to_field(bits[:, 32:44])
        fec_feedback = _bits_to_field(bits[:, 44:48])
        tb_offset = _bits_to_field(bits[:, 48:60])
        fec_scheme = _bits_to_field(bits[:, 60:64])
        tb_payload = _bits_to_field(bits[:, 64:80])
        n_msg = 80
    else:
        tb_no = fec_feedback = tb_offset = fec_scheme = tb_payload = z
        n_msg = 32
    crc_got = _bits_to_field(bits[:, n_msg : n_msg + 16])
    crc_want = _crc16_of_bits(bits, n_msg)
    fields = HeaderFields(
        payload_len, frame_no, cnst_id, feedback_cnst,
        tb_no, fec_feedback, tb_offset, fec_scheme, tb_payload,
    )
    return fields, crc_got == crc_want
