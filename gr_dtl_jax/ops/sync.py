"""Schmidl-Cox synchronization: timing metric, trigger detection, CFO.

Design note
-----------
The reference's ``digital.ofdm_sync_sc_cfb`` walks the stream sample by
sample updating running sums, and a separate trigger-repair block
(``ofdm_adaptive_frame_detect_bb_impl.cc:64-173``) fixes drifted /
missing triggers with a small state machine.  Here the timing metric
for the *whole* stream is computed at once with cumulative sums
(O(N), fully vectorized), candidate triggers are found by folding the
metric over the known frame period (every frame votes for the common
phase), and per-frame refinement picks the local plateau — the same
lock-to-period idea as the repair block but as array ops instead of a
state machine.

Frame timing geometry: sync word 1 occupies even carriers only, so its
64-sample useful part repeats with period 32.  Together with the cyclic
prefix (last 16 samples of the symbol) the period-32 repetition spans
samples [frame_start, frame_start+80) and the metric

    P(d) = sum_{m<32} conj(r[d+m]) r[d+m+32],   M(d) = |P|^2 / (R1 R2)

(R1/R2 = first/second half-window energies; Cauchy-Schwarz keeps
M <= 1 even on idle air and signal edges)

has a plateau for d in [frame_start, frame_start+cp_len].  The fine
(fractional-carrier) CFO is angle(P)/pi in subcarrier units.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "timing_metric",
    "fold_detect",
    "frame_triggers",
    "fine_cfo",
    "cfo_correct",
    "extract_windows",
    "extract_frames",
    "extract_frames_batch",
    "fine_cfo_batch",
]

_HALF = 32  # repetition lag: fft_len // 2


def extract_windows(stream: jax.Array, trig: jax.Array, length: int) -> jax.Array:
    """Gather per-trigger sample windows as contiguous slices.

    ``vmap(dynamic_slice)`` lowers to a slice-gather (one contiguous
    read per window) rather than the element-index gather
    ``stream[trig[:, None] + arange(length)]``.
    Out-of-range triggers are clamped to the window START (the last
    full window), so callers must pad the stream past the final frame
    (every call site already does).

    Args:
      stream: [N] complex64.
      trig:   [B] int32 window start indices.
      length: static window length.
    Returns [B, length].
    """
    t = jnp.clip(trig, 0, stream.shape[-1] - length)
    return jax.vmap(
        lambda ti: jax.lax.dynamic_slice(stream, (ti,), (length,))
    )(t)


def extract_frames(stream: jax.Array, trig: jax.Array, period: int,
                   tol: int = 4) -> jax.Array:
    """Per-trigger frame windows, with a periodic fast path.

    :func:`extract_windows` pays one dynamic-slice gather per frame.
    But a *locked* receiver's triggers are
    periodic by construction (frame k starts at phase + k*period, up to
    a few samples of refinement jitter), and a periodic window set is
    ONE contiguous slice + a reshape — near-free.  This wrapper checks
    the affine model in-graph: when every trigger sits within ``tol``
    samples of ``trig[0] + k*period`` it takes the slice+reshape path,
    else it falls back to the per-frame gather (`lax.cond`, only the
    taken branch executes outside vmap).

    Correctness of the fast path: a window taken d samples early/late
    (|d| <= tol < cp_len/2, the plateau-centroid guard band) stays
    inside its symbol's ISI-free CP region, and the shift applies to
    the frame's sync symbols identically, so the LS channel estimate
    absorbs the resulting linear phase exactly — same demodulated
    decisions, which the loopback/SFO/streaming tests pin.  Drift
    beyond ``tol`` across the batch (strong SFO, re-acquisition) takes
    the exact gather path.

    Args:
      stream: [N] complex64 (padded past the final frame, as for
        :func:`extract_windows`).
      trig:   [B] int32 window starts.
      period: nominal frame period (static).
    Returns [B, period].
    """
    B = trig.shape[0]
    if stream.shape[-1] < B * period:
        # the uniform grid would not fit (static shapes — known at
        # trace time): the clipped fast path would silently shift every
        # window, so use the per-window gather unconditionally
        return extract_windows(stream, trig, period)
    # anchor the affine model at the MEDIAN per-frame offset: centroid
    # refinement jitters +-3 samples around the typical plateau center,
    # so a first-frame anchor (edge effects) would miss the cluster
    rel = trig - jnp.arange(B, dtype=jnp.int32) * period
    base = jnp.median(rel).astype(jnp.int32)
    d = rel - base
    uniform = jnp.all(jnp.abs(d) <= tol)

    def fast(_):
        start = jnp.clip(base, 0, stream.shape[-1] - B * period)
        u = jax.lax.dynamic_slice(stream, (start,), (B * period,))
        return u.reshape(B, period)

    def slow(_):
        return extract_windows(stream, trig, period)

    return jax.lax.cond(uniform, fast, slow, None)


def extract_frames_batch(streams: jax.Array, trig: jax.Array, period: int,
                         tol: int = 4) -> jax.Array:
    """Batched :func:`extract_frames` with the fast/slow decision OUTSIDE
    any vmap: under ``vmap`` a ``lax.cond`` lowers to a select that runs
    BOTH branches, so a vmapped ``extract_frames`` always pays the
    gather.  Here one scalar uniformity vote across all streams picks
    one branch for the whole batch (sharded sessions run many locked
    streams in lockstep, so the vote almost always lands on fast).

    Args:
      streams: [S, N] per-stream sample rows.
      trig:    [S, B] per-stream window starts.
    Returns [S, B, period].
    """
    S, N = streams.shape
    B = trig.shape[1]

    def slow(_):
        return jax.vmap(lambda r, t: extract_windows(r, t, period))(
            streams, trig)

    if N < B * period:
        return slow(None)
    rel = trig - jnp.arange(B, dtype=jnp.int32)[None, :] * period
    base = jnp.median(rel, axis=1).astype(jnp.int32)       # [S]
    uniform = jnp.all(jnp.abs(rel - base[:, None]) <= tol)

    def fast(_):
        def per(row, b):
            start = jnp.clip(b, 0, N - B * period)
            return jax.lax.dynamic_slice(
                row, (start,), (B * period,)).reshape(B, period)

        return jax.vmap(per)(streams, base)

    return jax.lax.cond(uniform, fast, slow, None)


def fine_cfo_batch(P: jax.Array, trig: jax.Array, cp_len: int,
                   period: int, tol: int = 4) -> jax.Array:
    """Batched :func:`fine_cfo` with the batch-level fast/slow decision
    (same vmap-of-cond rationale as :func:`extract_frames_batch`).

    Args:
      P: [S, N'] per-stream correlation rows.
      trig: [S, B] triggers.
    Returns [S, B] fractional CFO.
    """
    S = P.shape[0]
    B = trig.shape[1]
    L = cp_len + 1

    def slow(_):
        def per(row, t):
            start = jnp.clip(t - cp_len // 2, 0, row.shape[-1] - L)
            return extract_windows(row, start, L)

        return jax.vmap(per)(P, trig)

    rel = trig - jnp.arange(B, dtype=jnp.int32)[None, :] * period
    base = jnp.median(rel, axis=1).astype(jnp.int32)
    uniform = jnp.all(jnp.abs(rel - base[:, None]) <= tol)
    wins = jax.lax.cond(
        uniform,
        lambda _: jax.vmap(
            lambda row, b: _periodic_rows(row, b - cp_len // 2, period, B,
                                          L, left_pad=cp_len))(P, base),
        slow, None)
    Pav = jnp.sum(wins, axis=-1)
    return (jnp.angle(Pav) / jnp.pi).astype(jnp.float32)


def _periodic_rows(x: jax.Array, base, period: int, n: int, length: int,
                   left_pad: int) -> jax.Array:
    """Rows ``x[base + k*period : +length]`` for k < n as ONE contiguous
    slice + reshape (the stride is exactly ``period``) — no per-row
    gather.  ``x`` is zero-padded ``left_pad`` on the left (so a
    negative ``base`` reads zeros, not a clipped/shifted window) and
    ``period + length`` on the right."""
    xp = jnp.pad(x, (left_pad, period + length))
    start = jnp.clip(base + left_pad, 0, xp.shape[-1] - n * period)
    u = jax.lax.dynamic_slice(xp, (start,), (n * period,))
    return u.reshape(n, period)[:, :length]


def _moving_sum(x: jax.Array, w: int) -> jax.Array:
    """[N] -> [N - w + 1] windowed sums, numerically exact at any N.

    NOT a global-cumsum difference: on multi-Msample streams a float32
    running sum grows past the 24-bit mantissa and the two-big-numbers
    difference corrupts the metric enough to mis-trigger later frames
    (observed as batch-size-dependent CRC failures).  Instead, two-level
    block sums: within each w-sized block an exclusive prefix, plus the
    block total — every term sums at most 2w values, so precision is
    independent of stream length.
    """
    n = x.shape[-1]
    out_len = n - w + 1
    nb = -(-n // w)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, nb * w - n)])
    X = xp.reshape(*x.shape[:-1], nb, w)
    pre = jnp.cumsum(X, axis=-1)
    epre = jnp.concatenate([jnp.zeros_like(pre[..., :1]), pre[..., :-1]], axis=-1)
    tot = pre[..., -1:]
    epre_next = jnp.concatenate(
        [epre[..., 1:, :], jnp.zeros_like(epre[..., :1, :])], axis=-2)
    # window starting at d = b*w + j: tail of block b from j, plus the
    # first j entries of block b+1
    ms = (tot - epre) + epre_next
    return ms.reshape(*x.shape[:-1], nb * w)[..., :out_len]


def timing_metric(r: jax.Array, fft_len: int = 64):
    """Schmidl-Cox P(d) and M(d) over a sample stream.

    Plain ``jax.numpy`` on every platform: the metric is a few
    elementwise products and two 32-wide sliding sums, which XLA fuses
    on its own.

    Args:
      r: [..., N] complex64 stream.
    Returns (P, M): each [..., N - fft_len], where index d corresponds
    to a correlation window starting at sample d.
    """
    half = fft_len // 2
    out = r.shape[-1] - fft_len
    lagged = jnp.conj(r[..., :-half]) * r[..., half:]  # [N-half]
    P = _moving_sum(lagged, half)[..., :out]
    # windowed energy E(d) = sum_{m<32} |r[d+m]|^2; the two half-window
    # energies are shifted views of it (R1(d) = E(d), R2(d) = E(d+32)),
    # so one moving sum serves both
    E = _moving_sum(jnp.abs(r) ** 2, half)
    R1 = E[..., :out]
    R2 = E[..., half : half + out]
    # normalize by BOTH half energies: Cauchy-Schwarz gives
    # |P|^2 <= R1*R2, so M <= 1 everywhere — including signal->silence
    # falling edges, where the one-sided |P|^2/R2^2 form explodes
    # (signal-x-noise numerator over a noise-only denominator) and
    # corrupts the fold vote on idle air
    M = jnp.abs(P) ** 2 / jnp.maximum(R1 * R2, 1e-12)
    return P, M


def fold_detect(M: jax.Array, frame_samples: int, cp_len: int = 16) -> jax.Array:
    """Find the common trigger phase by folding the metric over the period.

    Every frame in the stream votes for its start offset mod
    frame_samples; the phase is located with a *circular* boxcar match
    over the folded sum: the metric plateau is cp_len+1 wide and wraps
    around the fold boundary, and a raw argmax can lock onto the rising
    edge on the wrong side of the wrap (which would make time-sharded
    blocks decode their neighbour's frame through the halo).  The
    best cp-length circular window localizes the plateau; its center is
    returned.  Replaces the reference's lock-acquisition logic
    (frame_detect_bb: 3 consecutive synced triggers to lock) with a
    batch vote that uses *all* frames at once.

    Args:
      M: [N'] timing metric.
    Returns scalar int32 plateau-center offset in [0, frame_samples).
    """
    n_full = M.shape[-1] // frame_samples
    folded = jnp.sum(
        M[..., : n_full * frame_samples].reshape(*M.shape[:-1], n_full, frame_samples),
        axis=-2,
    )
    return phase_from_folded(folded, frame_samples, cp_len)


def phase_from_folded(folded: jax.Array, frame_samples: int,
                      cp_len: int = 16) -> jax.Array:
    """Circular plateau-center localization on a folded metric vote.

    Shared by :func:`fold_detect` and the sharded receiver (which folds
    locally and psums the vote across time shards before calling this).
    """
    k = cp_len + 1
    ext = jnp.concatenate([folded, folded[..., : k - 1]], axis=-1)
    win = _moving_sum(ext, k)  # [frame_samples] circular window sums
    start = jnp.argmax(win, axis=-1)
    return ((start + k // 2) % frame_samples).astype(jnp.int32)


def frame_triggers(M: jax.Array, phase: jax.Array, frame_samples: int,
                   n_frames: int, search: int = 24) -> jax.Array:
    """Per-frame trigger refinement around the folded phase (mod-period:
    a phase near the period boundary searches across it).

    The Schmidl-Cox metric has a flat plateau of cp_len+1 samples over
    [frame_start, frame_start+cp]; a raw argmax lands anywhere on it
    (noise can even push it a sample past the edge, causing ISI).  For
    frame k this searches M around phase + k*frame_samples and returns
    the *centroid* of the plateau (samples above 80% of the local max,
    metric-weighted) — which sits mid-CP, leaving ~cp/2 samples of
    guard on both sides.  Plays the role of the reference's trigger
    correction (ofdm_adaptive_frame_detect_bb_impl.cc:64-173).

    Returns [n_frames] int32 trigger positions (window-start indices).
    """
    L = 2 * search + 1
    # the search bases are exactly affine (phase + k*period), so the
    # [n_frames, L] value windows come out of one contiguous slice +
    # reshape instead of a per-frame gather (out-of-range positions
    # read zeros, which sit below the 0.8*max plateau threshold)
    start = phase - search + jnp.arange(n_frames, dtype=jnp.int32) \
        * frame_samples
    vals = _periodic_rows(M, phase - search, frame_samples, n_frames, L,
                          left_pad=search)
    local_max = jnp.max(vals, axis=-1, keepdims=True)
    on_plateau = vals > 0.8 * local_max
    w = jnp.where(on_plateau, vals, 0.0)
    # centroid over RELATIVE offsets: absolute sample indices overflow
    # float32's 24-bit mantissa on long streams (a few Msamples), which
    # skewed triggers by several samples and broke CRCs batch-dependently
    rel = jnp.arange(L, dtype=jnp.float32)[None, :]
    centroid_rel = jnp.sum(w * rel, axis=-1) / jnp.maximum(
        jnp.sum(w, axis=-1), 1e-12
    )
    return start + jnp.round(centroid_rel).astype(jnp.int32)


def fine_cfo(P: jax.Array, triggers: jax.Array, cp_len: int = 16,
             period: int | None = None) -> jax.Array:
    """Fractional CFO per frame, in subcarrier units: angle(P)/pi.

    Averages P over the metric plateau around the (centroid) trigger
    for noise robustness (the reference takes the single-sample value
    the ``ofdm_sync_sc_cfb`` block latched at the trigger).

    Pass ``period`` (the nominal frame period) to enable the periodic
    fast path: when the triggers fit the affine model (as
    :func:`extract_frames`), the [B, cp+1] plateau windows come from
    one contiguous slice + reshape; a median-anchor jitter of a few
    samples keeps the window on the plateau, where angle(P) is flat —
    the per-trigger gather remains the in-graph fallback.
    """
    L = cp_len + 1
    B = triggers.shape[0]

    def slow(_):
        start = jnp.clip(triggers - cp_len // 2, 0, P.shape[-1] - L)
        return extract_windows(P, start, L)

    if period is None:
        wins = slow(None)
    else:
        rel = triggers - jnp.arange(B, dtype=jnp.int32) * period
        base = jnp.median(rel).astype(jnp.int32)
        uniform = jnp.all(jnp.abs(rel - base) <= 4)
        wins = jax.lax.cond(
            uniform,
            lambda _: _periodic_rows(P, base - cp_len // 2, period, B, L,
                                     left_pad=cp_len),
            slow, None)
    Pav = jnp.sum(wins, axis=-1)
    return (jnp.angle(Pav) / jnp.pi).astype(jnp.float32)


def cfo_correct(frames: jax.Array, eps: jax.Array, fft_len: int = 64) -> jax.Array:
    """De-rotate per-frame sample windows by the fractional CFO.

    Args:
      frames: [B, frame_samples] complex sample windows (frame-aligned).
      eps:    [B] CFO in subcarrier units.
    Equivalent to the reference's oscillator+mixer path
    (frequency_modulator_fc(-2/fft_len) + multiply, ofdm_receiver.py:73-89)
    but applied per extracted frame window.
    """
    n = jnp.arange(frames.shape[-1], dtype=jnp.float32)
    ph = -2.0 * jnp.pi * eps[:, None] * n[None, :] / fft_len
    return frames * jnp.exp(1j * ph.astype(jnp.float32))
