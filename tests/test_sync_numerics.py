"""Long-stream float32 regressions: the Schmidl-Cox path must stay
numerically exact on multi-Msample streams (global-cumsum moving sums
and absolute-index centroids both silently corrupted sync past ~2M
samples before being replaced)."""

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.ops import channel
from gr_dtl_jax.ops import sync
from gr_dtl_jax.ops.sync import _moving_sum, extract_windows
from gr_dtl_jax.models import receiver, transmitter
import pytest


def test_moving_sum_exact_any_position():
    rng = np.random.RandomState(0)
    for n, w in ((1000, 32), (4097, 32), (64, 32), (33, 32), (97, 16)):
        x = rng.randn(n)
        ref = np.array([x[i:i + w].sum() for i in range(n - w + 1)])
        got = np.asarray(_moving_sum(jnp.asarray(x.astype(np.float32)), w))
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 1e-3, (n, w)
    # precision must not degrade with a huge DC offset far into the
    # stream (the global-cumsum version lost whole units here)
    n, w = 1 << 21, 32
    x = np.ones(n, np.float32)
    got = np.asarray(_moving_sum(jnp.asarray(x), w))
    assert np.abs(got - w).max() == 0.0


def test_extract_windows_matches_index_gather():
    rng = np.random.RandomState(1)
    s = (rng.randn(5000) + 1j * rng.randn(5000)).astype(np.complex64)
    trig = np.array([0, 7, 1234, 5000 - 100], np.int32)
    got = np.asarray(extract_windows(jnp.asarray(s), jnp.asarray(trig), 100))
    for i, t in enumerate(trig):
        np.testing.assert_array_equal(got[i], s[t:t + 100])


@pytest.mark.slow
def test_long_stream_detection_exact():
    """>2M-sample loopback: every frame must decode (float32 index
    precision bugs used to fail frames batch-size-dependently)."""
    cfg = cfgmod.make_rx_config(None, frame_length=4)
    txcfg = cfgmod.make_tx_config(None, frame_length=4)
    txp = transmitter.build_tx(txcfg)
    B = 4096  # 4096 * 560 samples = 2.3 Msamples
    rng = np.random.RandomState(2)
    maxb = txcfg.max_frame_bytes()
    plen = np.full(B, txcfg.frame_bytes(2) - 4, np.int32)
    payload = np.zeros((B, maxb), np.uint8)
    payload[:, : plen[0]] = rng.randint(0, 256, (B, plen[0]))

    @jax.jit
    def make_stream(p, l, c, f, k):
        out = transmitter.tx_frames(txp, p, l, c, jnp.zeros(B, jnp.int32), f, k)
        s = jnp.concatenate([out.samples.reshape(-1),
                             jnp.zeros(2048, jnp.complex64)])
        return channel.awgn(jax.random.PRNGKey(1), s, 0.02)

    stream = make_stream(jnp.asarray(payload), jnp.asarray(plen),
                         jnp.full(B, 2, jnp.int32),
                         jnp.arange(B, dtype=jnp.int32) % 4096,
                         jax.random.PRNGKey(0))

    @jax.jit
    def run(s):
        frames, _ = receiver.detect_and_extract(s, cfg, B)
        r = receiver.rx_frames(rxp, frames)
        return r.crc_ok

    rxp = receiver.build_rx(cfg)
    ok = np.asarray(run(stream))
    assert ok.all(), f"late-stream failures: {np.nonzero(~ok)[0][:10]}"


class TestTapDenoise:
    """Time-support projection (chanest.denoise_taps)."""

    def _ce(self):
        from gr_dtl_jax.utils import config as cfgmod
        from gr_dtl_jax.ops import chanest
        cfg = cfgmod.make_rx_config(None)
        return cfg, chanest.build_chanest(cfg)

    def test_noiseless_time_limited_channel_is_fixed_point(self):
        import numpy as np
        import jax.numpy as jnp
        from gr_dtl_jax.ops import chanest
        cfg, ce = self._ce()
        rng = np.random.RandomState(0)
        support = 2 * cfg.cp_len + 1
        g = (rng.randn(support) + 1j * rng.randn(support)) / np.sqrt(support)
        c = np.arange(cfg.fft_len) - cfg.fft_len // 2
        H = np.exp(-2j * np.pi * np.outer(c, np.arange(support)) / cfg.fft_len) @ g
        taps = np.where(ce["active"], H, 1.0).astype(np.complex64)
        out = np.asarray(chanest.denoise_taps(jnp.asarray(taps)[None], ce))[0]
        np.testing.assert_allclose(out[ce["active"]], taps[ce["active"]],
                                   rtol=2e-4, atol=2e-4)

    def test_noise_reduction(self):
        import numpy as np
        import jax.numpy as jnp
        from gr_dtl_jax.ops import chanest
        cfg, ce = self._ce()
        rng = np.random.RandomState(1)
        H = np.exp(-2j * np.pi * (np.arange(cfg.fft_len) - 32) * 16 / 64)
        noise = 0.3 * (rng.randn(64) + 1j * rng.randn(64))
        noisy = np.where(ce["active"], H + noise, 1.0).astype(np.complex64)
        out = np.asarray(chanest.denoise_taps(jnp.asarray(noisy)[None], ce))[0]
        a = ce["active"]
        err_in = np.mean(np.abs(noisy[a] - H[a]) ** 2)
        err_out = np.mean(np.abs(out[a] - H[a]) ** 2)
        # |S|/n_active = 33/52 -> ~2 dB; assert we get most of it
        assert err_out < 0.75 * err_in


def test_extract_frames_fallback_matches_gather():
    """Non-affine triggers (drift > tol) must take the exact gather
    path: extract_frames == extract_windows bit-for-bit."""
    rng = np.random.RandomState(0)
    P = 560
    B = 6
    stream = jnp.asarray((rng.randn(B * P + 800)
                          + 1j * rng.randn(B * P + 800)).astype(np.complex64))
    # drifting triggers: deviation grows past the +-4 tolerance
    trig = jnp.asarray((np.arange(B) * P + 100
                        + np.arange(B) * 3).astype(np.int32))
    got = sync.extract_frames(stream, trig, P)
    want = sync.extract_windows(stream, trig, P)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_extract_frames_fast_path_takes_affine_slices():
    """Affine triggers (jitter <= tol around the median anchor) take the
    slice+reshape path: windows equal the gather at the ANCHORED
    positions (uniform grid), which stay within the jitter of the
    requested ones."""
    rng = np.random.RandomState(1)
    P = 560
    B = 8
    stream = jnp.asarray((rng.randn(B * P + 800)
                          + 1j * rng.randn(B * P + 800)).astype(np.complex64))
    jitter = np.array([0, 1, -2, 3, -1, 2, 0, 1], np.int32)
    base = 97
    trig = jnp.asarray(np.arange(B, dtype=np.int32) * P + base + jitter)
    got = np.asarray(sync.extract_frames(stream, trig, P))
    anchor = int(np.median(base + jitter))
    uniform = jnp.asarray(np.arange(B, dtype=np.int32) * P + anchor)
    want = np.asarray(sync.extract_windows(stream, uniform, P))
    np.testing.assert_array_equal(got, want)


def test_fine_cfo_periodic_matches_gather_on_affine():
    """fine_cfo with a period hint agrees with the per-trigger gather
    form when triggers are exactly affine (same windows)."""
    rng = np.random.RandomState(2)
    P = 560
    B = 8
    Pm = jnp.asarray((rng.randn(B * P + 800)
                      + 1j * rng.randn(B * P + 800)).astype(np.complex64))
    trig = jnp.asarray(np.arange(B, dtype=np.int32) * P + 123)
    a = np.asarray(sync.fine_cfo(Pm, trig, 16))
    b = np.asarray(sync.fine_cfo(Pm, trig, 16, period=P))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_extract_frames_batch_fallback_and_fast():
    """Batch form: non-affine triggers in ANY stream push the whole
    batch to the exact gather; all-affine batches take the anchored
    slice path (windows equal the per-stream anchored gather)."""
    rng = np.random.RandomState(3)
    P, S, B = 560, 3, 5
    streams = jnp.asarray((rng.randn(S, B * P + 700)
                           + 1j * rng.randn(S, B * P + 700))
                          .astype(np.complex64))
    # one stream drifts -> whole batch takes the gather path
    trig = np.tile(np.arange(B, dtype=np.int32) * P + 90, (S, 1))
    trig[1] += np.arange(B, dtype=np.int32) * 3
    got = np.asarray(sync.extract_frames_batch(streams, jnp.asarray(trig), P))
    want = np.stack([np.asarray(sync.extract_windows(streams[s],
                                                     jnp.asarray(trig[s]), P))
                     for s in range(S)])
    np.testing.assert_array_equal(got, want)
    # all-affine with small jitter -> anchored fast path per stream
    jit2 = np.array([0, 1, -2, 2, -1], np.int32)
    trig2 = np.stack([np.arange(B, dtype=np.int32) * P + 80 + 7 * s + jit2
                      for s in range(S)])
    got2 = np.asarray(sync.extract_frames_batch(streams,
                                                jnp.asarray(trig2), P))
    for s in range(S):
        anchor = int(np.median(trig2[s] - np.arange(B) * P))
        uni = jnp.asarray(np.arange(B, dtype=np.int32) * P + anchor)
        np.testing.assert_array_equal(
            got2[s], np.asarray(sync.extract_windows(streams[s], uni, P)))


def test_fine_cfo_batch_matches_per_stream():
    """Batch plateau-CFO equals the per-stream gather form on exactly
    affine triggers."""
    rng = np.random.RandomState(4)
    P, S, B = 560, 3, 5
    Pm = jnp.asarray((rng.randn(S, B * P + 700)
                      + 1j * rng.randn(S, B * P + 700)).astype(np.complex64))
    trig = jnp.asarray(np.stack(
        [np.arange(B, dtype=np.int32) * P + 101 + 5 * s for s in range(S)]))
    got = np.asarray(sync.fine_cfo_batch(Pm, trig, 16, P))
    want = np.stack([np.asarray(sync.fine_cfo(Pm[s], trig[s], 16))
                     for s in range(S)])
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("n", [9000, 8256])
def test_timing_metric_matches_float64_sliding_sums(n):
    """The metric against direct float64 sliding sums of its definition:
    P(d) = sum_{m<32} conj(r[d+m]) r[d+m+32], M = |P|^2 / (R1 R2)."""
    rng = np.random.RandomState(n)
    r = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    P, M = sync.timing_metric(jnp.asarray(r), 64)
    r64 = r.astype(np.complex128)
    out = n - 64
    P_ref = np.array([np.sum(np.conj(r64[d:d + 32]) * r64[d + 32:d + 64])
                      for d in range(out)])
    R1 = np.array([np.sum(np.abs(r64[d:d + 32]) ** 2) for d in range(out)])
    R2 = np.array([np.sum(np.abs(r64[d + 32:d + 64]) ** 2)
                   for d in range(out)])
    assert P.shape == M.shape == (out,)
    np.testing.assert_allclose(np.asarray(P), P_ref, atol=2e-4 * np.abs(
        P_ref).max())
    np.testing.assert_allclose(np.asarray(M), np.abs(P_ref) ** 2 / (R1 * R2),
                               atol=1e-4)
