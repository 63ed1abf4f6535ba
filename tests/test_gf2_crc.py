"""CRC golden tests: device affine-CRC vs host bitwise vs known vectors.

Mirrors the reference's CRC usage (SURVEY.md #21): frame CRC32
(crc_util.cc:23), header CRC16 (packet_header.cc:72), feedback CRC8
(feedback_format.cc:36).
"""

import binascii

import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.ops import gf2


def test_crc32_matches_zlib():
    data = b"123456789"
    assert gf2.crc_host(data, gf2.CRC32_FRAME) == binascii.crc32(data)
    assert gf2.crc_host(data, gf2.CRC32_FRAME) == 0xCBF43926


def test_crc8_check_value():
    # CRC-8 (poly 0x07, init 0xFF, no xor, no reflect) of "123456789" = 0xF7
    # minus init difference; compute directly against an independent impl.
    def crc8(data):
        reg = 0xFF
        for b in data:
            reg ^= b
            for _ in range(8):
                reg = ((reg << 1) ^ 0x07) & 0xFF if reg & 0x80 else (reg << 1) & 0xFF
        return reg

    data = b"\x02\x01"
    assert gf2.crc_host(data, gf2.CRC8_FEEDBACK) == crc8(data)


@pytest.mark.parametrize("spec", [gf2.CRC32_FRAME, gf2.CRC16_HEADER, gf2.CRC8_FEEDBACK])
def test_device_crc_matches_host(spec):
    max_len = 48
    rng = np.random.RandomState(0)
    B = 16
    lengths = rng.randint(0, max_len + 1, size=B).astype(np.int32)
    msgs = np.zeros((B, max_len), dtype=np.uint8)
    for i, L in enumerate(lengths):
        msgs[i, :L] = rng.randint(0, 256, size=L)

    tables = gf2.make_crc_tables(spec, max_len)
    got = np.asarray(gf2.crc_device(jnp.asarray(msgs), jnp.asarray(lengths), tables))
    want = np.array(
        [gf2.crc_host(msgs[i, : lengths[i]].tobytes(), spec) for i in range(B)],
        dtype=np.uint32,
    )
    np.testing.assert_array_equal(got, want)


def test_device_crc_large_frame():
    # QAM16 frame: 480 bytes (20 syms * 48 carriers * 4 bps / 8)
    spec = gf2.CRC32_FRAME
    max_len = 480
    rng = np.random.RandomState(1)
    msg = rng.randint(0, 256, size=(1, max_len)).astype(np.uint8)
    tables = gf2.make_crc_tables(spec, max_len)
    got = int(np.asarray(gf2.crc_device(jnp.asarray(msg), jnp.asarray([max_len]), tables))[0])
    assert got == binascii.crc32(msg[0].tobytes())
