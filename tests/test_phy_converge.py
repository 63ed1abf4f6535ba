"""Convergence layer: validators + to_phy/from_phy round trips through
the native library (mirrors the reference's packet_validator.cc /
from_phy_impl.cc / to_phy_impl.cc semantics)."""

import struct

import numpy as np
import pytest

from gr_dtl_jax.testbed.phy_converge import (
    FromPhy, Protocol, to_phy_frame, validate_packet,
)

MAC = "02:50:aa:bb:cc:01"


def _ipv4_packet(payload: bytes) -> bytes:
    total = 20 + len(payload)
    hdr = bytearray(struct.pack(
        "!BBHHHBBH4s4s", 0x45, 0, total, 0x1234, 0, 64, 17, 0,
        bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2]),
    ))
    # IPv4 header checksum
    s = 0
    for i in range(0, 20, 2):
        s += (hdr[i] << 8) | hdr[i + 1]
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    struct.pack_into("!H", hdr, 10, (~s) & 0xFFFF)
    return bytes(hdr) + payload


def _ether(payload: bytes, dst=MAC) -> bytes:
    dst_b = bytes(int(x, 16) for x in dst.split(":"))
    src_b = b"\x02\x50\xaa\xbb\xcc\x02"
    # reference reads the length at offset 16 (inside the IPv4 header)
    return dst_b + src_b + b"\x08\x00" + payload


def test_ip_validator():
    pkt = _ipv4_packet(b"hello world")
    ok, plen = validate_packet(Protocol.IPV4_ONLY, pkt)
    assert ok and plen == len(pkt)
    bad = bytearray(pkt)
    bad[12] ^= 0xFF  # corrupt src addr -> checksum fails
    ok, _ = validate_packet(Protocol.IPV4_ONLY, bytes(bad))
    assert not ok


def test_ether_validator():
    ip = _ipv4_packet(b"x" * 30)
    pkt = _ether(ip)
    ok, plen = validate_packet(Protocol.ETHER_IPV4, pkt, MAC)
    assert ok and plen == 14 + len(ip)
    ok, _ = validate_packet(Protocol.ETHER_IPV4, pkt, "ff:ff:ff:ff:ff:ff")
    assert not ok


def test_to_from_phy_modified_ether_roundtrip():
    rng = np.random.RandomState(0)
    pdus = [bytes(int(x, 16) for x in MAC.split(":")) + b"\x02\x50\xaa\xbb\xcc\x02"
            + rng.bytes(n) for n in (40, 100, 7)]
    stream = b"".join(to_phy_frame(Protocol.MODIFIED_ETHER, p) for p in pdus)
    # framer inserted the 2-byte length after the MAC header
    assert len(stream) == sum(len(p) + 2 for p in pdus)

    fp = FromPhy(Protocol.MODIFIED_ETHER, MAC)
    packets = fp.process(stream)
    assert packets == pdus
    fp.close()


def test_from_phy_jumbo_across_calls():
    rng = np.random.RandomState(1)
    pdu = (bytes(int(x, 16) for x in MAC.split(":"))
           + b"\x02\x50\xaa\xbb\xcc\x02" + rng.bytes(200))
    stream = to_phy_frame(Protocol.MODIFIED_ETHER, pdu)
    fp = FromPhy(Protocol.MODIFIED_ETHER, MAC)
    first = fp.process(stream[:50])   # partial: no completed packet tag
    second = fp.process(stream[50:])  # completes the packet
    got = (first + second)
    # reassembled bytes must contain the original pdu as final packet
    assert got[-1] == pdu or b"".join(got) == pdu
    fp.close()


def test_from_phy_garbage_passthrough():
    fp = FromPhy(Protocol.MODIFIED_ETHER, MAC)
    garbage = b"\x00\x01\x02\x03" * 10
    pkts = fp.process(garbage)
    assert b"".join(pkts) == garbage  # upper layer gets it tagged as-is
    fp.close()
