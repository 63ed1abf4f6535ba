"""Idle-air / bursty-traffic behavior: streams
where only some frame slots carry energy.  The reference's frame_detect
unlocks after 5 missing triggers and re-locks after 3 consistent ones
(frame_detect_bb_impl.cc:21-22); lost-frame accounting must not invent
losses for air that never carried a frame."""

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.ops import channel
from gr_dtl_jax.models import session, transmitter
import pytest


def _tx_frames(txcfg, txp, frame_nos, seed=0):
    B = len(frame_nos)
    rng = np.random.RandomState(seed)
    maxb = txcfg.max_frame_bytes()
    plen = np.full(B, txcfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((B, maxb), np.uint8)
    for i in range(B):
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen),
        jnp.full(B, 2, jnp.int32), jnp.zeros(B, jnp.int32),
        jnp.asarray(frame_nos, jnp.int32), jax.random.PRNGKey(seed))
    return np.asarray(out.samples), payload, plen


def test_bursty_traffic_with_silent_gaps():
    """Two 8-frame bursts separated by ~3 blocks of silence: every sent
    frame decodes exactly once, the silence produces zero decodes and
    ZERO phantom lost-frame counts (TX numbering is consecutive across
    the gap, like a paused reference framer)."""
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    F = 4
    P = cfg.frame_samples

    s1, pay1, plen = _tx_frames(txcfg, txp, np.arange(8), seed=1)
    s2, pay2, _ = _tx_frames(txcfg, txp, np.arange(8, 16), seed=2)
    gap = np.zeros(3 * F * P, np.complex64)  # 12 empty frame slots
    stream = np.concatenate([
        s1.reshape(-1), gap, s2.reshape(-1),
        np.zeros(2 * F * P, np.complex64)])
    sig = float(np.mean(np.abs(s1) ** 2))
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(3), jnp.asarray(stream),
        float(np.sqrt(sig / 1e3))))

    rx = session.StreamRx(cfg, frames_per_block=F)
    S = rx.block_samples
    stream = stream[: (len(stream) // S) * S]
    decoded = {}
    for b in range(len(stream) // S):
        outb, valid = rx.process(stream[b * S:(b + 1) * S])
        ok = np.asarray(outb.crc_ok) & valid
        for i in range(F):
            if ok[i]:
                fno = int(np.asarray(outb.frame_no)[i])
                assert fno not in decoded, f"frame {fno} decoded twice"
                decoded[fno] = bytes(
                    np.asarray(outb.payload)[i, : plen[0]])
    assert sorted(decoded) == list(range(16)), sorted(decoded)
    for i in range(8):
        assert decoded[i] == pay1[i, : plen[0]].tobytes()
        assert decoded[8 + i] == pay2[i, : plen[0]].tobytes()
    # the silent gap must not inflate the lost-frame counter: numbering
    # is consecutive, so the gap contains no lost frames at all
    assert rx.n_lost == 0, rx.n_lost
    assert rx.lost_frame_rate == 0.0


@pytest.mark.slow
def test_partially_filled_block():
    """A block where only 2 of 4 slots carry frames: both decode, the
    empty slots decode nothing, and accounting stays clean."""
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    F = 4
    P = cfg.frame_samples
    s, pay, plen = _tx_frames(txcfg, txp, np.arange(2), seed=4)
    # slots: [frame0, empty, empty, frame1] repeated pattern start
    stream = np.concatenate([
        s[0], np.zeros(2 * P, np.complex64), s[1],
        np.zeros(3 * F * P, np.complex64)])
    sig = float(np.mean(np.abs(s) ** 2))
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(5), jnp.asarray(stream),
        float(np.sqrt(sig / 1e3))))
    rx = session.StreamRx(cfg, frames_per_block=F)
    S = rx.block_samples
    stream = stream[: (len(stream) // S) * S]
    got = {}
    for b in range(len(stream) // S):
        outb, valid = rx.process(stream[b * S:(b + 1) * S])
        ok = np.asarray(outb.crc_ok) & valid
        for i in range(F):
            if ok[i]:
                got[int(np.asarray(outb.frame_no)[i])] = True
    assert sorted(got) == [0, 1]
    assert rx.n_lost == 0


def test_long_idle_then_resume():
    """8 frames, then ~6 blocks of pure noise (past the unlock budget),
    then 8 more frames: the receiver re-acquires and decodes the second
    burst completely."""
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    txp = transmitter.build_tx(txcfg)
    F = 4
    P = cfg.frame_samples
    s1, pay1, plen = _tx_frames(txcfg, txp, np.arange(8), seed=6)
    s2, pay2, _ = _tx_frames(txcfg, txp, np.arange(8, 16), seed=7)
    idle = np.zeros(6 * F * P, np.complex64)
    stream = np.concatenate([
        s1.reshape(-1), idle, s2.reshape(-1),
        np.zeros(2 * F * P, np.complex64)])
    sig = float(np.mean(np.abs(s1) ** 2))
    stream = np.asarray(channel.awgn(
        jax.random.PRNGKey(8), jnp.asarray(stream),
        float(np.sqrt(sig / 10 ** 2.5))))
    rx = session.StreamRx(cfg, frames_per_block=F)
    S = rx.block_samples
    stream = stream[: (len(stream) // S) * S]
    got = set()
    for b in range(len(stream) // S):
        outb, valid = rx.process(stream[b * S:(b + 1) * S])
        ok = np.asarray(outb.crc_ok) & valid
        for i in range(F):
            if ok[i]:
                fno = int(np.asarray(outb.frame_no)[i])
                assert fno not in got
                got.add(fno)
    assert got == set(range(16)), sorted(got)
    assert rx.n_lost == 0
