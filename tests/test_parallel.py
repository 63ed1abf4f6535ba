"""Sharded receiver on a virtual 8-device CPU mesh: dp (streams) x sp
(time blocks with ppermute halo exchange), results must match the
single-device receiver byte-exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.ops import channel, constellation as cn
from gr_dtl_jax.models import receiver, transmitter
from gr_dtl_jax.parallel import mesh as meshmod, stream as pstream


def _tx_streams(cfg, n_streams, frames_per_stream, seed=0):
    txp = transmitter.build_tx(cfg)
    rng = np.random.RandomState(seed)
    B = n_streams * frames_per_stream
    cnst = rng.randint(1, 5, size=B).astype(np.int32)
    maxb = cfg.max_frame_bytes()
    payload = np.zeros((B, maxb), np.uint8)
    plen = np.zeros(B, np.int32)
    for i in range(B):
        plen[i] = cfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst[i]])) - 4
        payload[i, : plen[i]] = rng.randint(0, 256, plen[i])
    out = transmitter.tx_frames(
        txp, jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
        jnp.zeros(B, jnp.int32), jnp.arange(B, dtype=jnp.int32) % 4096,
        jax.random.PRNGKey(seed),
    )
    streams = out.samples.reshape(n_streams, frames_per_stream * cfg.frame_samples)
    return streams, payload.reshape(n_streams, frames_per_stream, maxb), cnst


def test_sharded_rx_matches_reference_path():
    assert jax.device_count() >= 8
    cfg = cfgmod.make_rx_config(None, frame_length=10)
    m = meshmod.make_mesh(n_stream=2, n_time=4)
    n_streams, fpb, n_blocks = 2, 2, 4
    frames_per_stream = fpb * n_blocks

    streams, payload, cnst = _tx_streams(cfg, n_streams, frames_per_stream)
    sig = float(jnp.mean(jnp.abs(streams) ** 2))
    noise_v = np.sqrt(sig / 10 ** 3)
    streams = channel.awgn(jax.random.PRNGKey(7), streams, noise_v)

    fn, rxp = pstream.build_sharded_rx(cfg, m, frames_per_block=fpb)
    out = fn(streams)
    crc_ok = np.asarray(out.crc_ok)
    pay = np.asarray(out.payload)
    assert crc_ok.shape == (n_streams, frames_per_stream)
    assert crc_ok.all(), f"sharded rx CRC failures: {crc_ok}"
    np.testing.assert_array_equal(pay, payload)

    # cross-check one stream against the single-device path
    frames = streams[0].reshape(frames_per_stream, cfg.frame_samples)
    ref = receiver.rx_frames(rxp, frames)
    np.testing.assert_array_equal(np.asarray(ref.payload), payload[0])


def test_sharded_loopback_full_step():
    """TX + channel + RX as ONE SPMD program over the (stream, time)
    mesh: per-shard modulation, ppermute halo, psum phase vote."""
    assert jax.device_count() >= 8
    txcfg = cfgmod.make_tx_config(None, frame_length=10)
    rxcfg = cfgmod.make_rx_config(None, frame_length=10)
    m = meshmod.make_mesh(n_stream=2, n_time=4)
    n_streams, fpb, n_time = 2, 2, 4
    frames_per_stream = fpb * n_time

    rng = np.random.RandomState(21)
    maxb = txcfg.max_frame_bytes()
    cnst = rng.randint(1, 5, (n_streams, frames_per_stream)).astype(np.int32)
    plen = np.zeros((n_streams, frames_per_stream), np.int32)
    payload = np.zeros((n_streams, frames_per_stream, maxb), np.uint8)
    for s in range(n_streams):
        for f in range(frames_per_stream):
            plen[s, f] = txcfg.frame_bytes(int(cn.BITS_PER_SYMBOL[cnst[s, f]])) - 4
            payload[s, f, : plen[s, f]] = rng.randint(0, 256, plen[s, f])
    frame_no = np.tile(np.arange(frames_per_stream, dtype=np.int32),
                       (n_streams, 1))

    step, _ = pstream.build_sharded_loopback(
        txcfg, rxcfg, m, frames_per_block=fpb, noise_v=0.02)
    out = step(jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
               jnp.asarray(frame_no), jax.random.PRNGKey(5))
    crc_ok = np.asarray(out.crc_ok)
    assert crc_ok.shape == (n_streams, frames_per_stream)
    assert crc_ok.all(), f"failures: {np.argwhere(~crc_ok)}"
    pay = np.asarray(out.payload)
    for s in range(n_streams):
        for f in range(frames_per_stream):
            np.testing.assert_array_equal(
                pay[s, f, : plen[s, f]], payload[s, f, : plen[s, f]])


def test_64_streams_pod_config():
    """BASELINE config 5: 64 parallel adaptive-OFDM streams sharded over
    a (stream x time) mesh with halo exchange, mixed MCS per frame."""
    assert jax.device_count() >= 8
    cfg = cfgmod.make_rx_config(None, frame_length=4)
    m = meshmod.make_mesh(n_stream=4, n_time=2)
    n_streams, fpb, n_blocks = 64, 1, 2
    frames_per_stream = fpb * n_blocks

    streams, payload, cnst = _tx_streams(cfg, n_streams, frames_per_stream, seed=11)
    sig = float(jnp.mean(jnp.abs(streams) ** 2))
    streams = channel.awgn(jax.random.PRNGKey(12), streams, np.sqrt(sig / 10 ** 3))

    fn, rxp = pstream.build_sharded_rx(cfg, m, frames_per_block=fpb)
    out = fn(streams)
    crc_ok = np.asarray(out.crc_ok)
    assert crc_ok.shape == (n_streams, frames_per_stream)
    assert crc_ok.all(), f"failures: {np.argwhere(~crc_ok)}"
    np.testing.assert_array_equal(np.asarray(out.payload), payload)


def test_sharded_coded_loopback_exact_recovery():
    """The full SPMD step with LDPC transport blocks: TX (FEC framer) +
    channel + halo-exchanging RX with in-graph BP decode, sharded over
    (stream, time) — every TB must recover exactly at comfortable SNR
    (the coded counterpart of test_sharded_loopback_full_step)."""
    from gr_dtl_jax.models import fec_chain
    from gr_dtl_jax.utils import alist as alist_mod
    import os

    assert jax.device_count() >= 8
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    H = alist_mod.load_alist(os.path.join(here, "examples",
                                          "n_0100_k_0027.alist"))
    txcfg = cfgmod.make_tx_config(None, frame_length=4, fec=True)
    rxcfg = cfgmod.make_rx_config(None, frame_length=4, fec=True)
    fec = fec_chain.build_fec(txcfg, H)
    m = meshmod.make_mesh(n_stream=4, n_time=2)
    fpb = 2
    step, _ = pstream.build_sharded_loopback(
        txcfg, rxcfg, m, frames_per_block=fpb, noise_v=0.01, fec=fec)

    rng = np.random.RandomState(5)
    S = 4
    F = m.shape["time"] * fpb
    cnst = np.full((S, F), 2, np.int32)
    maxb = fec["max_payload_bytes"]
    plen = np.full((S, F), int(fec["user_bytes_tab"][2]), np.int32)
    payload = np.zeros((S, F, maxb), np.uint8)
    for s in range(S):
        for f in range(F):
            payload[s, f, : plen[s, f]] = rng.randint(0, 256, plen[s, f])
    out = step(jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(cnst),
               np.tile(np.arange(F, dtype=np.int32), (S, 1)),
               jax.random.PRNGKey(0))
    assert np.asarray(out.header_ok).all()
    assert np.asarray(out.crc_ok).all(), "coded sharded step failed CRC"
    got = np.asarray(out.payload).reshape(S, F, -1)
    for s in range(S):
        for f in range(F):
            L = plen[s, f]
            assert (got[s, f, :L] == payload[s, f, :L]).all(), (s, f)
