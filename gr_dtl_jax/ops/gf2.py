"""GF(2) linear algebra on device: bit-matrix multiplies and affine CRC.

Design note
-----------
The reference computes CRCs byte-by-byte on the host
(``gr::digital::crc``, used via ``lib/dtl/crc_util.cc:23-56``,
``lib/dtl/ofdm_adaptive_packet_header.cc:72`` and
``lib/dtl/ofdm_adaptive_feedback_format.cc:36``).  A byte-wise loop is a
worst case for XLA (long sequential scan, no vector work).  CRC over
GF(2) is *affine* in the message bits, so here the whole computation is
re-cast as one matmul over a batch of frames plus a tiny per-frame
length correction:

    crc(m, L) = reflect_out( T_{8L} · (D · m)  ⊕  init · x^{8L} mod p ) ⊕ xor_out

where (working in GF(2)[x] / p(x), x invertible because p(0)=1):

- ``D``      is a fixed ``[max_bits, width]`` matrix whose column *i* is
  the bit-vector of ``x^{-(i+1)} mod p`` — so ``D·m`` only depends on the
  message bits *from the start*, letting messages stay left-aligned and
  zero-padded to a static shape (XLA needs static shapes),
- ``T_{8L}`` is the ``[width, width]`` multiply-by-``x^{8L+width}``
  matrix, precomputed for every possible byte length ``L`` and gathered
  per frame,
- ``init · x^{8L} mod p`` is a precomputed per-length constant.

All matrices are built once on the host with exact integer polynomial
arithmetic; on device everything is float32 matmuls followed by
``mod 2``.  They are exact at DEFAULT precision: 0/1 operands are exact
in TF32 and the sums accumulate in float32, far below 2^24.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "CrcSpec",
    "CRC32_FRAME",
    "CRC16_HEADER",
    "CRC8_FEEDBACK",
    "crc_host",
    "make_crc_tables",
    "crc_device",
    "gf2_matmul",
]


# ---------------------------------------------------------------------------
# Host-side exact polynomial arithmetic over GF(2)
# ---------------------------------------------------------------------------

def _gf2_mulmod(a: int, b: int, poly: int, width: int) -> int:
    """(a*b) mod (x^width + poly) with carry-less multiplication."""
    full_poly = (1 << width) | poly
    res = 0
    while b:
        if b & 1:
            res ^= a
        b >>= 1
        a <<= 1
        if a >> width & 1:
            a ^= full_poly
    # reduce res (can be up to 2*width-1 bits)
    for bit in range(res.bit_length() - 1, width - 1, -1):
        if res >> bit & 1:
            res ^= full_poly << (bit - width)
    return res


def _gf2_powmod(base: int, exp: int, poly: int, width: int) -> int:
    res = 1
    base %= 1 << width  # base already reduced by construction
    while exp:
        if exp & 1:
            res = _gf2_mulmod(res, base, poly, width)
        base = _gf2_mulmod(base, base, poly, width)
        exp >>= 1
    return res


def _gf2_inv_x(poly: int, width: int) -> int:
    """x^{-1} mod p.  Since p(0)=1:  x^{-1} = (p(x)+1)/x  (drop const, shift)."""
    full_poly = (1 << width) | poly
    assert full_poly & 1, "CRC polynomial must have a nonzero constant term"
    return (full_poly ^ 1) >> 1


def _bitrev(v: int, width: int) -> int:
    out = 0
    for _ in range(width):
        out = (out << 1) | (v & 1)
        v >>= 1
    return out


@dataclasses.dataclass(frozen=True)
class CrcSpec:
    """CRC parameters, mirroring ``gr::digital::crc``'s constructor order."""

    width: int
    poly: int
    init: int
    xor_out: int
    reflect_in: bool
    reflect_out: bool


# The three CRCs of the reference protocol:
# frame payload CRC32  (ref lib/dtl/ofdm_adaptive_frame_bb_impl.cc:64 via
#                       crc_util.cc:23 -> reflect in+out)
CRC32_FRAME = CrcSpec(32, 0x04C11DB7, 0xFFFFFFFF, 0xFFFFFFFF, True, True)
# header CRC16         (ref lib/dtl/ofdm_adaptive_packet_header.cc:72)
CRC16_HEADER = CrcSpec(16, 0x1021, 0xFFFF, 0x0, False, True)
# feedback burst CRC8  (ref lib/dtl/ofdm_adaptive_feedback_format.cc:36)
CRC8_FEEDBACK = CrcSpec(8, 0x07, 0xFF, 0x00, False, False)


def crc_host(data: bytes | np.ndarray, spec: CrcSpec) -> int:
    """Reference bitwise CRC on the host (golden model for tests)."""
    data = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    reg = spec.init
    top = 1 << (spec.width - 1)
    mask = (1 << spec.width) - 1
    for byte in data.tolist():
        if spec.reflect_in:
            byte = _bitrev(byte, 8)
        reg ^= byte << (spec.width - 8)
        for _ in range(8):
            reg = ((reg << 1) ^ spec.poly) if reg & top else (reg << 1)
            reg &= mask
    if spec.reflect_out:
        reg = _bitrev(reg, spec.width)
    return reg ^ spec.xor_out


# ---------------------------------------------------------------------------
# Device-side affine-CRC tables
# ---------------------------------------------------------------------------

def _int_to_bits(v: int, width: int) -> np.ndarray:
    return np.array([(v >> i) & 1 for i in range(width)], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def make_crc_tables(spec: CrcSpec, max_len_bytes: int):
    """Precompute (D, T, init_term) for messages of up to max_len_bytes.

    Returns a dict of numpy arrays:
      D         [max_bits, width]   column i = bits of x^{-(i+1)} mod p
      T         [max_len+1, width, width]  multiply by x^{8L+width}
      init_term [max_len+1, width]  bits of init*x^{8L} mod p
    """
    w, p = spec.width, spec.poly
    max_bits = max_len_bytes * 8
    inv_x = _gf2_inv_x(p, w)

    D = np.zeros((max_bits, w), dtype=np.float32)
    cur = 1  # x^0; we need x^{-(i+1)} so multiply before storing
    for i in range(max_bits):
        cur = _gf2_mulmod(cur, inv_x, p, w)
        D[i] = _int_to_bits(cur, w)

    T = np.zeros((max_len_bytes + 1, w, w), dtype=np.float32)
    init_term = np.zeros((max_len_bytes + 1, w), dtype=np.float32)
    for L in range(max_len_bytes + 1):
        mult = _gf2_powmod(2, 8 * L + w, p, w)  # x^{8L+width} mod p
        for j in range(w):
            # column j: (x^j * mult) mod p
            T[L, j] = _int_to_bits(_gf2_mulmod(1 << j, mult, p, w), w)
        init_term[L] = _int_to_bits(
            _gf2_mulmod(spec.init, _gf2_powmod(2, 8 * L, p, w), p, w), w
        )
    return {"D": D, "T": T, "init_term": init_term, "spec": spec}


def gf2_matmul(bits: jax.Array, mat: jax.Array) -> jax.Array:
    """(bits @ mat) mod 2 with exact float32 accumulation."""
    acc = jnp.dot(
        bits.astype(jnp.float32), mat.astype(jnp.float32),
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )
    return jnp.mod(acc, 2.0)


def _bytes_to_crc_bitstream(msg: jax.Array, spec: CrcSpec) -> jax.Array:
    """[.., N] uint8 -> [.., N*8] bits in CRC feed order (msb- or lsb-first)."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8) if not spec.reflect_in else jnp.arange(8, dtype=jnp.uint8)
    bits = (msg[..., None] >> shifts) & 1
    return bits.reshape(*msg.shape[:-1], msg.shape[-1] * 8)


def crc_device(msg: jax.Array, lengths: jax.Array, tables) -> jax.Array:
    """Batched CRC on device.

    Args:
      msg:     [B, max_len] uint8, each row's bytes beyond its length MUST be 0.
      lengths: [B] int32 message byte lengths.
      tables:  output of :func:`make_crc_tables` (numpy arrays are fine; XLA
               will constant-fold them into the compiled graph).

    Returns [B] uint32 CRC values.
    """
    spec: CrcSpec = tables["spec"]
    w = spec.width
    bits = _bytes_to_crc_bitstream(msg, spec).astype(jnp.float32)  # [B, maxbits]
    v = gf2_matmul(bits, jnp.asarray(tables["D"]))  # [B, w]
    T = jnp.asarray(tables["T"])[lengths]  # [B, w, w]
    core = jnp.mod(jnp.einsum("bj,bjw->bw", v, T,
                              precision=jax.lax.Precision.DEFAULT), 2.0)
    core = jnp.mod(core + jnp.asarray(tables["init_term"])[lengths], 2.0)
    core = core.astype(jnp.uint32)
    weights = (
        jnp.uint32(1) << jnp.arange(w - 1, -1, -1, dtype=jnp.uint32)
        if spec.reflect_out
        else jnp.uint32(1) << jnp.arange(w, dtype=jnp.uint32)
    )
    crc = jnp.sum(core * weights, axis=-1, dtype=jnp.uint32)
    return crc ^ jnp.uint32(spec.xor_out)
