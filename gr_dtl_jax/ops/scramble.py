"""Additive (XOR) LFSR scrambler, per-frame reset.

Mirrors GNU Radio's ``digital.additive_scrambler_bb(0x8a, seed, 7)`` as
used (and by default disabled — seed 0) by the reference
(``python/dtl/ofdm_receiver.py:61-65,219-226``): a Galois LFSR with
7-bit register, polynomial mask 0x8A, XORed over the payload bits and
reset at every frame boundary.

Design: the per-frame reset makes every frame see the *same*
scramble sequence, so the whole sequence is precomputed once on the
host and applied as one vectorized XOR over the frame byte batch — no
per-bit feedback loop on the device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["lfsr_bytes", "scramble_frames"]


@functools.lru_cache(maxsize=None)
def lfsr_bytes(mask: int = 0x8A, seed: int = 0x7F, reg_len: int = 7,
               n_bytes: int = 1024) -> np.ndarray:
    """Byte sequence of the additive scrambler (LSB-first bit packing,
    matching the byte-wise application with bits_per_byte=8).

    gr::digital::lfsr semantics, bit-exact with the reference's
    scrambler: output = LSB of the register; the feedback bit (parity of
    register & mask) shifts into bit position *reg_len* (i.e. the state
    is reg_len+1 bits wide — see gr lfsr.h's ``newbit <<
    d_shift_register_length``).  With (0x8A, 0x7F, 7) the emitted
    sequence has period 63, exactly what additive_scrambler_bb
    produces.
    """
    reg = seed
    out = np.zeros(n_bytes, dtype=np.uint8)
    for i in range(n_bytes):
        b = 0
        for j in range(8):
            bit = reg & 1
            newbit = bin(reg & mask).count("1") & 1
            reg = (reg >> 1) | (newbit << reg_len)
            b |= bit << j
        out[i] = b
    return out


def scramble_frames(frames: jax.Array, seed: int = 0x7F) -> jax.Array:
    """XOR-scramble (or descramble — involution) a [B, n_bytes] batch.

    seed 0 disables scrambling (all-zero sequence), exactly like the
    reference's deactivation trick (ofdm_receiver.py:61-65).
    """
    if seed == 0:
        return frames
    seq = jnp.asarray(lfsr_bytes(0x8A, seed, 7, frames.shape[-1]))
    return frames ^ seq[None, :]
