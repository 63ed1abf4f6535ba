"""Narrowband feedback burst modem: BPSK burst TX + data-aided burst RX.

Protocol (matches the reference exactly,
``lib/dtl/ofdm_adaptive_feedback_format.cc:69-151``):

    burst = [64-bit access code | constellation byte | FEC byte | CRC8]

88 bits, MSB-first per byte, BPSK, 2 samples/symbol, root-raised-cosine
pulse (excess bandwidth 0.35) with a ramped burst shape
(ref python/dtl/ofdm_adaptive_rx.py:62-110).  Access code = GNU Radio's
default (0xAC DD A4 E2 F2 8C 20 FC); CRC8 poly 0x07 init 0xFF.

Design note
-----------
The reference receives bursts with closed per-sample tracking loops:
``corr_est_cc`` -> ``pfb_clock_sync_ccf`` (polyphase timing PLL) ->
``costas_loop_cc`` (carrier PLL) -> slicer -> sliding access-code
search (ref python/dtl/ofdm_adaptive_tx.py:44-85).  Feedback PLLs are
sample-sequential and ill-suited to SIMD hardware; for an 88-symbol
burst they are also statistically inferior to *data-aided one-shot
estimation*.  Here the receiver is fully vectorized:

 1. matched filter (RRC) over the capture,
 2. cross-correlation against the known shaped preamble -> peak index
    (timing), complex peak (amplitude + phase), and the phase *slope*
    between the two preamble halves -> CFO,
 3. fractional timing by quadratic interpolation of the correlation
    magnitude around the peak,
 4. de-rotate, sample at symbol strobes, BPSK-decide,
 5. sliding access-code match (vectorized Hamming distance over all
    alignments, threshold as in the reference parser) + CRC8 gate.

Everything is static-shaped; a batch of captures demodulates in one
fused graph.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.ops import gf2

__all__ = ["ACCESS_CODE_BITS", "rrc_taps", "build_burst_modem",
           "burst_tx", "burst_rx", "BurstRxOut", "burst_wave_len",
           "build_stream_burst_rx"]

# GNU Radio default access code, 64 bits MSB-first
_ACCESS_BYTES = bytes([0xAC, 0xDD, 0xA4, 0xE2, 0xF2, 0x8C, 0x20, 0xFC])
ACCESS_CODE_BITS = np.array(
    [(b >> (7 - i)) & 1 for b in _ACCESS_BYTES for i in range(8)], dtype=np.int32
)
N_BURST_BITS = 64 + 24  # access + cnst + fec + crc8


def rrc_taps(sps: int, eb: float, ntaps: int, gain: float = 1.0) -> np.ndarray:
    """Root-raised-cosine FIR (same parametrization as
    filter.firdes.root_raised_cosine with nfilts folded out)."""
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0) / sps  # in symbols
    a = eb
    h = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - a + 4 * a / np.pi
        elif a > 0 and abs(abs(ti) - 1 / (4 * a)) < 1e-9:
            h[i] = (a / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * a))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * a))
            )
        else:
            h[i] = (
                np.sin(np.pi * ti * (1 - a)) + 4 * a * ti * np.cos(np.pi * ti * (1 + a))
            ) / (np.pi * ti * (1 - (4 * a * ti) ** 2))
    h = h / np.sqrt(np.sum(h**2)) * gain
    return h.astype(np.float32)


class BurstRxOut(NamedTuple):
    cnst_id: jax.Array  # [B] int32
    fec_id: jax.Array  # [B] int32
    ok: jax.Array  # [B] bool (access code found + CRC8 good)
    peak_pos: jax.Array  # [B] int32 detected burst start (diagnostic)
    cfo: jax.Array  # [B] float32 rad/sample (diagnostic)


def build_burst_modem(sps: int = 2, eb: float = 0.35, ntaps_syms: int = 11):
    """Precompute pulse shapes and the shaped preamble waveform."""
    ntaps = ntaps_syms * sps + 1
    taps = rrc_taps(sps, eb, ntaps)
    # shaped preamble: BPSK access code upsampled and RRC filtered
    # BPSK map matches ops/constellation: bit 0 -> -1, bit 1 -> +1
    sym = 2.0 * ACCESS_CODE_BITS.astype(np.float32) - 1.0
    up = np.zeros(64 * sps, np.float32)
    up[::sps] = sym
    pre = np.convolve(up, taps)  # [64*sps + ntaps - 1]
    crc_tables = gf2.make_crc_tables(gf2.CRC8_FEEDBACK, 2)
    return {
        "sps": sps,
        "taps": taps,
        "ntaps": ntaps,
        "preamble_wave": pre.astype(np.complex64),
        "crc_tables": crc_tables,
    }


def _burst_bits(cnst_id: jax.Array, fec_id: jax.Array, modem) -> jax.Array:
    """[B] -> [B, 88] bits: access | cnst | fec | crc8 (MSB-first)."""
    B = cnst_id.shape[0]
    msg = jnp.stack([cnst_id, fec_id], axis=1).astype(jnp.uint8)  # [B, 2]
    crc = gf2.crc_device(msg, jnp.full((B,), 2, jnp.int32), modem["crc_tables"])
    def byte_bits(v):
        return (v[:, None].astype(jnp.int32) >> jnp.arange(7, -1, -1)) & 1
    return jnp.concatenate(
        [
            jnp.broadcast_to(jnp.asarray(ACCESS_CODE_BITS)[None], (B, 64)),
            byte_bits(cnst_id), byte_bits(fec_id), byte_bits(crc),
        ],
        axis=1,
    )


def burst_tx(cnst_id: jax.Array, fec_id: jax.Array, modem,
             pad: int = 32) -> jax.Array:
    """Modulate feedback bursts.

    Returns [B, pad + 88*sps + ntaps - 1 + pad] complex64 waveforms.
    """
    sps = modem["sps"]
    bits = _burst_bits(cnst_id, fec_id, modem)  # [B, 88]
    sym = (2.0 * bits - 1.0).astype(jnp.float32)
    B = sym.shape[0]
    up = jnp.zeros((B, N_BURST_BITS * sps), jnp.float32)
    up = up.at[:, ::sps].set(sym)
    taps = jnp.asarray(modem["taps"])
    shaped = jax.vmap(lambda x: jnp.convolve(x, taps))(up)
    wave = shaped.astype(jnp.complex64)
    z = jnp.zeros((B, pad), jnp.complex64)
    return jnp.concatenate([z, wave, z], axis=1)


def burst_wave_len(modem) -> int:
    """Length of one shaped burst waveform (no padding)."""
    return N_BURST_BITS * modem["sps"] + modem["ntaps"] - 1


def build_stream_burst_rx(modem, block: int, max_bursts: int = 4,
                          threshold: float = 0.5):
    """Continuous-capture burst scanner: 0..max_bursts per block.

    The reference's feedback parser scans an endless sample stream with
    a sliding access-code correlator
    (``ofdm_adaptive_feedback_format.cc:119-146``, fed by ``corr_est_cc``
    in ``ofdm_adaptive_tx.py:44-60``).  Here the scan is one fused
    batch graph per block:

    1. normalized preamble cross-correlation over [tail | block],
    2. non-max suppression (a start wins if it is the correlation max
       within a burst-length window) + threshold -> candidate starts,
    3. ownership: only starts inside the first ``block`` coordinates
       are emitted now (later ones reappear at the front of the next
       block's extended window — same tail discipline as the OFDM
       StreamRx), so every burst is demodulated exactly once,
    4. ``top_k`` candidates -> windows sliced out and demodulated by
       the one-shot estimator (:func:`burst_rx`) in one vmapped batch.

    Returns ``(step, tail_len)`` where ``step(ext) -> BurstRxOut`` with
    [max_bursts] leading dims and ``ext = concat(tail, chunk)``,
    ``tail = previous chunk's last tail_len samples``.  Slots beyond the
    number of detected bursts have ``ok=False``.
    """
    Lb = burst_wave_len(modem)
    pre = jnp.asarray(modem["preamble_wave"])
    Lp = pre.shape[0]
    tail_len = Lb  # any burst starting in the owned region completes
    win = Lb + 8  # demod window per candidate

    pre_conj_rev = jnp.conj(pre[::-1])
    e_pre = jnp.sum(jnp.abs(pre) ** 2)

    def step(ext: jax.Array) -> BurstRxOut:
        T = ext.shape[-1]  # tail_len + block
        corr = jnp.convolve(ext, pre_conj_rev, mode="full")
        # correlation aligned so index s = burst start in ext coords
        c = corr[Lp - 1 : Lp - 1 + T]
        # normalized by local energy under the preamble: moving sum
        p2 = jnp.abs(ext) ** 2
        cs = jnp.concatenate([jnp.zeros(1), jnp.cumsum(p2)])
        e_loc = cs[jnp.minimum(jnp.arange(T) + Lp, T)] - cs[: T]
        norm = jnp.abs(c) / jnp.sqrt(jnp.maximum(e_loc * e_pre, 1e-12))
        # non-max suppression over a burst-length window
        mag = jnp.abs(c)
        wmax = jax.lax.reduce_window(
            mag, -jnp.inf, jax.lax.max, (Lb,), (1,), "SAME")
        owned = jnp.arange(T) < block  # ownership region (see docstring)
        cand = (norm > threshold) & (mag >= wmax) & owned
        score = jnp.where(cand, mag, -1.0)
        top, starts = jax.lax.top_k(score, max_bursts)
        found = top > 0

        def demod_one(s):
            s = jnp.clip(s, 0, T - win)
            return jax.lax.dynamic_slice(ext, (s,), (win,))

        wins = jax.vmap(demod_one)(starts)  # [K, win]
        out = burst_rx(wins, modem)
        return BurstRxOut(
            cnst_id=out.cnst_id,
            fec_id=out.fec_id,
            ok=out.ok & found,
            peak_pos=starts.astype(jnp.int32),
            cfo=out.cfo,
        )

    return step, tail_len


def burst_rx(samples: jax.Array, modem) -> BurstRxOut:
    """Demodulate feedback bursts from [B, N] captures (one burst each)."""
    sps = modem["sps"]
    taps = jnp.asarray(modem["taps"])
    pre = jnp.asarray(modem["preamble_wave"])
    B, N = samples.shape

    # 1. matched filter
    mf = jax.vmap(lambda x: jnp.convolve(x, taps.astype(jnp.complex64), mode="full"))(
        samples
    )  # [B, N + ntaps - 1]

    # 2. preamble cross-correlation (on the raw samples: the preamble
    # template is already TX-shaped; correlating raw keeps one RRC)
    pre_conj_rev = jnp.conj(pre[::-1])
    corr = jax.vmap(lambda x: jnp.convolve(x, pre_conj_rev, mode="full"))(samples)
    # burst start s corresponds to correlation index s + len(pre) - 1
    mag = jnp.abs(corr)
    peak = jnp.argmax(mag, axis=1)  # [B]
    pk = jnp.take_along_axis(corr, peak[:, None], axis=1)[:, 0]
    energy = jnp.sum(jnp.abs(pre) ** 2)
    amp = jnp.abs(pk) / energy
    phase = jnp.angle(pk)

    # CFO from the phase difference of half-preamble correlations
    half = pre.shape[0] // 2
    pre1 = jnp.conj(pre[:half][::-1])
    pre2 = jnp.conj(pre[half:][::-1])
    c1 = jax.vmap(lambda x: jnp.convolve(x, pre1, mode="full"))(samples)
    c2 = jax.vmap(lambda x: jnp.convolve(x, pre2, mode="full"))(samples)
    # align: halves peak "half" samples apart; sample both at the full peak
    i1 = jnp.clip(peak - (pre.shape[0] - half), 0, c1.shape[1] - 1)
    p1 = jnp.take_along_axis(c1, i1[:, None], axis=1)[:, 0]
    p2 = jnp.take_along_axis(c2, peak[:, None], axis=1)[:, 0]
    cfo = jnp.angle(p2 * jnp.conj(p1)) / half  # rad/sample

    # 3. symbol strobes: burst start sample in the mf output.
    # corr peak index p = s + len(pre) - 1 where s = start in `samples`;
    # mf index of symbol k's strobe = s + (ntaps-1)/2*?  — both mf and
    # preamble template include one RRC; the first symbol center in mf
    # sits at s + (ntaps - 1) aligning template group delays:
    start = peak - (pre.shape[0] - 1)  # burst start s in samples
    # fractional timing: quadratic fit of |corr| around the peak
    pm1 = jnp.take_along_axis(mag, jnp.clip(peak - 1, 0, N + pre.shape[0] - 2)[:, None], axis=1)[:, 0]
    pp1 = jnp.take_along_axis(mag, jnp.clip(peak + 1, 0, N + pre.shape[0] - 2)[:, None], axis=1)[:, 0]
    p0 = jnp.abs(pk)
    denom = pm1 - 2 * p0 + pp1
    frac = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (pm1 - pp1) / denom, 0.0)
    frac = jnp.clip(frac, -0.5, 0.5)

    ntaps = modem["ntaps"]
    k = jnp.arange(N_BURST_BITS, dtype=jnp.int32)[None, :]
    strobe_f = (start[:, None] + frac[:, None]) + (ntaps - 1) + (k * sps).astype(jnp.float32)
    s0 = jnp.clip(jnp.floor(strobe_f).astype(jnp.int32), 0, mf.shape[1] - 2)
    sf = strobe_f - s0.astype(jnp.float32)
    n = jnp.arange(mf.shape[1], dtype=jnp.float32)
    derot = mf * jnp.exp(-1j * (phase[:, None] + cfo[:, None] * (n[None, :] - peak[:, None].astype(jnp.float32))))
    y0 = jnp.take_along_axis(derot, s0, axis=1)
    y1 = jnp.take_along_axis(derot, s0 + 1, axis=1)
    y = y0 * (1 - sf) + y1 * sf  # [B, 88] linear interp at the strobe
    y = y / jnp.maximum(amp[:, None], 1e-9)

    bits = (y.real > 0).astype(jnp.int32)

    # 4. access-code check at the nominal alignment + CRC8
    ac = jnp.asarray(ACCESS_CODE_BITS)
    nwrong = jnp.sum(bits[:, :64] != ac[None, :], axis=1)
    ac_ok = nwrong <= 0  # threshold 0, like the reference default

    def byte_of(b):
        return jnp.sum(b * (jnp.int32(1) << jnp.arange(7, -1, -1)), axis=1)

    cnst = byte_of(bits[:, 64:72])
    fec = byte_of(bits[:, 72:80])
    crc_rx = byte_of(bits[:, 80:88])
    msg = jnp.stack([cnst, fec], axis=1).astype(jnp.uint8)
    crc_want = gf2.crc_device(
        msg, jnp.full((B,), 2, jnp.int32), modem["crc_tables"]
    ).astype(jnp.int32)
    ok = ac_ok & (crc_rx == crc_want)
    return BurstRxOut(
        cnst_id=cnst.astype(jnp.int32),
        fec_id=fec.astype(jnp.int32),
        ok=ok,
        peak_pos=start.astype(jnp.int32),
        cfo=cfo.astype(jnp.float32),
    )
