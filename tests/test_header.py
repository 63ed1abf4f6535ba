"""Golden-vector tests for the frame header formatter/parser.

Mirrors the reference's ``qa_ofdm_adaptive_packet_header.py:73-151``:
the expected header bits are produced by an INDEPENDENT bit-by-bit
Python implementation of the layout documented at
``lib/dtl/ofdm_adaptive_packet_header.cc:166-187`` (short) and
``:113-123`` (FEC long header), so a shared bug in ops/header.py cannot
self-validate.
"""

import numpy as np
import jax.numpy as jnp

from gr_dtl_jax.ops import header


def _crc16_bitwise(msg_bytes):
    """CRC16 poly 0x1021 init 0xFFFF, input not reflected, output
    reflected (gr::digital::crc(16, 0x1021, 0xFFFF, 0, false, true);
    ref packet_header.cc:72)."""
    reg = 0xFFFF
    for b in msg_bytes:
        for i in range(7, -1, -1):  # MSB first (no input reflection)
            bit = (b >> i) & 1
            top = (reg >> 15) & 1
            reg = ((reg << 1) & 0xFFFF) ^ (0x1021 if top ^ bit else 0)
    # reflect the 16-bit result
    out = 0
    for i in range(16):
        out |= ((reg >> i) & 1) << (15 - i)
    return out


def _ref_header_bits(payload_len, frame_no, cnst, fb_cnst, fec=None):
    """Independent formatter: fields LSB-first, CRC16 over the message
    bits packed MSB-first into bytes, CRC inserted LSB-first."""
    bits = []

    def put(val, n):
        bits.extend((val >> i) & 1 for i in range(n))

    put(payload_len & 0xFFF, 12)
    put(frame_no & 0xFFF, 12)
    put(cnst & 0xF, 4)
    put(fb_cnst & 0xF, 4)
    if fec is not None:
        tb_no, fec_fb, tb_off, scheme, tb_payload = fec
        put(tb_no & 0xFFF, 12)
        put(fec_fb & 0xF, 4)
        put(tb_off & 0xFFF, 12)
        put(scheme & 0xF, 4)
        put(tb_payload & 0xFFFF, 16)
    msg_bytes = []
    for i in range(0, len(bits), 8):
        byte = 0
        for j in range(8):  # pack MSB-first (ref pack_crc)
            byte = (byte << 1) | bits[i + j]
        msg_bytes.append(byte)
    put(_crc16_bitwise(msg_bytes), 16)
    return np.array(bits, np.int32)


def _fields(payload_len, frame_no, cnst, fb, fec=(0, 0, 0, 0, 0)):
    a = lambda v: jnp.asarray([v], jnp.int32)
    tb_no, fec_fb, tb_off, scheme, tb_pay = fec
    return header.HeaderFields(
        a(payload_len), a(frame_no), a(cnst), a(fb),
        a(tb_no), a(fec_fb), a(tb_off), a(scheme), a(tb_pay),
    )


def test_short_header_golden_bits():
    cases = [
        (96, 0, 2, 2),
        (4095, 4095, 15, 15),
        (1, 1, 0, 3),
        (300, 1234, 3, 1),
    ]
    for payload_len, frame_no, cnst, fb in cases:
        got = np.asarray(header.format_header(
            _fields(payload_len, frame_no, cnst, fb), has_fec=False))[0]
        want = _ref_header_bits(payload_len, frame_no, cnst, fb)
        assert got.shape == (48,)
        np.testing.assert_array_equal(got, want)


def test_fec_header_golden_bits():
    fec = (77, 1, 150, 2, 9999)
    got = np.asarray(header.format_header(
        _fields(96, 42, 3, 2, fec), has_fec=True))[0]
    want = _ref_header_bits(96, 42, 3, 2, fec)
    assert got.shape == (96,)
    np.testing.assert_array_equal(got, want)


def test_parse_roundtrip_and_crc_gate():
    f = _fields(512, 77, 2, 1, (5, 1, 30, 1, 600))
    for has_fec in (False, True):
        bits = header.format_header(f, has_fec)
        parsed, ok = header.parse_header(bits, has_fec)
        assert bool(ok[0])
        assert int(parsed.payload_len[0]) == 512
        assert int(parsed.frame_no[0]) == 77
        assert int(parsed.cnst_id[0]) == 2
        assert int(parsed.feedback_cnst[0]) == 1
        if has_fec:
            assert int(parsed.tb_no[0]) == 5
            assert int(parsed.tb_offset[0]) == 30
            assert int(parsed.tb_payload[0]) == 600
        # every single-bit flip must fail the CRC16 gate
        # (ref parser updates state only on CRC ok, packet_header.cc:261-273)
        n = bits.shape[-1]
        flipped = jnp.tile(bits, (n, 1)) ^ jnp.eye(n, dtype=bits.dtype)
        _, ok_flipped = header.parse_header(flipped, has_fec)
        assert not bool(jnp.any(ok_flipped))


def test_batched_format_matches_scalar():
    rng = np.random.RandomState(3)
    B = 16
    pl = rng.randint(0, 4096, B)
    fn = rng.randint(0, 4096, B)
    cn = rng.randint(0, 16, B)
    fb = rng.randint(0, 16, B)
    batched = header.HeaderFields(
        *(jnp.asarray(x, jnp.int32) for x in (pl, fn, cn, fb)),
        *(jnp.zeros(B, jnp.int32) for _ in range(5)),
    )
    got = np.asarray(header.format_header(batched, has_fec=False))
    for i in range(B):
        np.testing.assert_array_equal(
            got[i], _ref_header_bits(pl[i], fn[i], cn[i], fb[i]))
