"""Continuous streaming sessions: block-by-block TX/RX with carried state.

The runtime piece replacing GNU Radio's always-on scheduler.

:class:`StreamRx` consumes an endless sample stream in fixed-size
blocks (any whole number of frame periods), carrying across blocks

- a held sample *tail* so frames straddling block boundaries complete,
- the trigger lock state machine (models/streaming.trigger_lock_scan —
  the reference's frame_detect lock/unlock semantics),
- the last known constellation (the reference parser's
  ``d_constellation`` memory, packet_header.cc:269-273) as the header-
  failure fallback,
- a running expected frame number for lost-frame accounting.

:class:`StreamTx` is the continuous framer/modulator: a host-side PDU
queue feeds a jitted per-block modulator, with the reference TX
framer's streaming behaviors (``ofdm_adaptive_frame_bb_impl.cc``):

- whole-PDU frame packing incl. jumbo split (pdu_consumer semantics),
- **empty-frame generation** when the queue is dry (ref :320-338) with
  the ``max_empty_frames`` give-up budget (``TxConfig``),
- **wall-clock frame pacing** to ``sample_rate`` (the reference's
  ``sleep_until`` pacing, ref :186-190) — optional, host-side,
- feedback-driven MCS switch (``process_feedback_header``, ref
  :111-130) and feedback echo for the outgoing headers (ref :333-336).

:class:`StreamDuplex` wires two ``StreamTx`` + two ``StreamRx`` into a
host-level always-on full-duplex modem with in-band adaptation — the
streaming counterpart of models/full_duplex.py's in-graph session.

One jitted per-block function per direction; the host loop only moves
small carries and byte queues between calls.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.ops import burst, constellation as cn, sync
from gr_dtl_jax.models import adaptive, receiver, streaming, transmitter

__all__ = ["StreamRx", "StreamRxPipelined", "StreamRxMega", "StreamTx",
           "StreamDuplex", "StreamBurstRx", "StreamSimplex"]


class BlockMasks(np.ndarray):
    """The per-block validity mask, with the block's other per-frame
    masks riding along as attributes (``header_ok``, ``crc_ok``).

    All three come out of ONE packed device fetch per block
    (StreamRx._readback); attaching them to the returned ``valid``
    array keeps them tied to *their* block even when readbacks are
    pipelined/drained out of order — session-level ``last_*``
    attributes would hold only the most recent block's masks there.
    Behaves exactly like a bool ndarray for existing callers, and the
    attributes survive numpy operations that derive new arrays (views,
    slices, ufunc results, copies) via ``__array_finalize__``.
    """

    header_ok: np.ndarray
    crc_ok: np.ndarray

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.header_ok = getattr(obj, "header_ok", None)
        self.crc_ok = getattr(obj, "crc_ok", None)


class StreamRx:
    """Feed me sample chunks; I emit per-frame RxOut batches.

    Args:
      cfg: RxConfig.
      frames_per_block: frames demodulated per jitted step; chunks
        passed to :meth:`process` must contain exactly this many frame
        periods (the constructor exposes ``block_samples``).
    """

    def __init__(self, cfg, frames_per_block: int = 16, fec=None,
                 probe=None):
        self.cfg = cfg
        self.F = frames_per_block
        # optional continuous telemetry: a testbed.monitor.MonitorProbe
        # (or anything with .send(bytes)); every processed block
        # publishes one MonitorEqMsg per received frame, mirroring the
        # reference's always-on monitor attachment
        # (ofdm_adaptive_frame_equalizer_vcvc_impl.cc:210-216)
        self.probe = probe
        self._eq_builder = None
        if probe is not None:
            from gr_dtl_jax.testbed import monitor as _mon

            self._mon = _mon
            self._eq_builder = _mon.MonitorProto(_mon.EQ_MSG)
        self.P = cfg.frame_samples
        self.block_samples = self.F * self.P
        # tail: enough history to finish a frame that starts near the
        # end of the previous block + the metric lookahead
        self.tail_len = self.P + cfg.fft_len
        self.rxp = receiver.build_rx(cfg, fec)
        # multi-frame transport blocks: loss-resilient reassembly keyed
        # by the header's tb_no/tb_offset (ref tb_decoder.cc:90-138);
        # :meth:`process` then returns a third element with decoded TBs
        self.fec = fec
        self._use_tb = fec is not None and fec["W"] > 1
        if self._use_tb:
            from gr_dtl_jax.models import fec_chain

            self._flush_fn = jax.jit(
                lambda em: fec_chain.decode_emitted(fec, em))
        self._step = self._build_step()
        self.reset()
        # ingest plumbing: the carried tail lives ON DEVICE and the
        # tail+chunk concat happens in-graph, so each block's H2D moves
        # only the new samples — and :meth:`prefetch` lets the caller
        # start block k+1's transfer while block k computes
        # (double-buffered ingest)
        tl = self.tail_len

        @jax.jit
        def step_tc(tail, chunk, lock_state, fallback_cnst, expected_no,
                    tb_state=None):
            res = self._step(jnp.concatenate([tail, chunk]), lock_state,
                             fallback_cnst, expected_no, tb_state)
            return res + (chunk[-tl:],)

        self._step_tc = step_tc
        self._zeros_tail = jax.jit(
            lambda: jnp.zeros(tl, jnp.complex64))

    def reset(self):
        """Forget all carried state, as for a new stream; the compiled
        block step is kept."""
        if self._use_tb:
            from gr_dtl_jax.models import fec_chain

            self._tb_state = fec_chain.init_tb_state(self.fec)
        self._tail = None  # device [tail_len], created by the first step
        self._lock = streaming.TriggerLockState(
            locked=jnp.asarray(False), expected=jnp.asarray(0),
            sync_count=jnp.asarray(0), miss_count=jnp.asarray(0),
        )
        self._fallback = jnp.full((self.F,), int(cn.ConstellationType.BPSK),
                                  jnp.int32)
        # lost-frame accounting (ref frame_equalizer_vcvc_impl.cc:124-137):
        # 12-bit frame-number gaps, carried across blocks; -1 = no frame
        # seen yet
        self._expected_no = jnp.asarray(-1, jnp.int32)
        self.n_lost = 0
        self.n_frames = 0
        # per-frame masks of the most recently read-back block (numpy,
        # set by _readback's single packed fetch) — consumers use these
        # instead of re-fetching out.header_ok / out.crc_ok
        self.last_valid = np.zeros(self.F, bool)
        self.last_header_ok = np.zeros(self.F, bool)
        self.last_crc_ok = np.zeros(self.F, bool)

    def _build_step(self):
        cfg, F, P = self.cfg, self.F, self.P
        rxp = self.rxp
        use_tb, fec = self._use_tb, self.fec

        @jax.jit
        def step(samples, lock_state, fallback_cnst, expected_no,
                 tb_state=None):
            """samples: [tail + block] complex64; triggers are owned by
            the tail-start coordinate system (frame k starts in the
            first F periods of `samples`)."""
            Pm, M = sync.timing_metric(samples, cfg.fft_len)
            phase = sync.fold_detect(M[: F * P], P, cfg.cp_len)
            cand = sync.frame_triggers(M, phase, P, F)
            # plausibility per candidate: metric level at the trigger
            lvl = M[jnp.clip(cand, 0, M.shape[-1] - 1)]
            found = lvl > 0.5
            lock_state, (trig, valid) = streaming.trigger_lock_scan(
                lock_state, cand, found, P
            )
            eps = sync.fine_cfo(Pm, trig, cfg.cp_len, period=P)
            frames = sync.cfo_correct(
                sync.extract_frames(samples, trig, P), eps, cfg.fft_len)
            tb_out = None
            if use_tb:
                from gr_dtl_jax.models import fec_chain

                out, fec_in = receiver.rx_frames(
                    rxp, frames, fallback_cnst=fallback_cnst, defer_fec=True)
                tb_state, emitted = fec_chain.tb_reassemble(
                    tb_state, fec_in["llrs"], fec_in["tb_no"],
                    fec_in["tb_offset"], out.cnst_id, fec_in["tb_payload"],
                    fec_in["fec_id"], out.header_ok & valid, fec)
                dec = fec_chain.decode_emitted(fec, emitted)
                tb_out = {"payload": dec.payload,
                          "payload_len": dec.payload_len,
                          "crc_ok": dec.crc_ok, "fec_ok": dec.fec_ok,
                          "tb_no": emitted["tb_no"],
                          "valid": emitted["valid"]}
            else:
                out = receiver.rx_frames(rxp, frames,
                                         fallback_cnst=fallback_cnst)
            # next fallback: last frame's accepted constellation
            new_fallback = jnp.full((F,), out.cnst_id[-1], jnp.int32)
            # rebase the lock expectation into the next block's coords
            lock_state = lock_state._replace(
                expected=lock_state.expected - F * P
            )
            # lost-frame accounting across blocks: gaps between RECEIVED
            # frame numbers only (ref frame_equalizer_vcvc_impl.cc:124-137);
            # undecoded slots (noise, idle air) never advance the
            # expectation, so a quiet stretch doesn't wrap the 12-bit
            # counter into thousands of phantom losses
            ok = out.header_ok & valid

            def acct(exp, x):
                no, okf = x
                first = exp < 0
                gap = jnp.where(first, 0, (no - exp) % 4096)
                lost = jnp.where(okf, gap, 0)
                new_exp = jnp.where(okf, (no + 1) % 4096, exp)
                return new_exp, lost

            expected_no, losts = jax.lax.scan(
                acct, expected_no, (out.frame_no, ok))
            # ONE packed accounting vector per block: [lost, received,
            # valid[F], header_ok[F], crc_ok[F]] — every per-block host
            # fact rides a single device->host copy
            acct_v = jnp.concatenate([
                jnp.stack([jnp.sum(losts), jnp.sum(ok)]),
                valid.astype(jnp.int32),
                out.header_ok.astype(jnp.int32),
                out.crc_ok.astype(jnp.int32),
            ])
            return (out, valid, lock_state, new_fallback, expected_no,
                    acct_v, tb_state, tb_out)

        return step

    def prefetch(self, chunk: np.ndarray):
        """Start the host->device transfer of a FUTURE block now.

        Double-buffered ingest: call right after dispatching block k
        with block k+1's samples, then pass the returned device handle
        to the next :meth:`process` call in place of the numpy chunk —
        the transfer overlaps block k's compute instead of serializing
        in front of block k+1's dispatch.
        """
        return jax.device_put(
            np.ascontiguousarray(np.asarray(chunk, np.complex64)))

    def _dispatch(self, chunk):
        """Launch the jitted block step and update the carried state;
        returns the (device-resident) results for a later readback.
        ``chunk`` is numpy samples or a :meth:`prefetch` handle."""
        assert chunk.shape[-1] == self.block_samples, (
            f"feed exactly {self.block_samples} samples per call"
        )
        if not isinstance(chunk, jax.Array):
            chunk = self.prefetch(chunk)
        if self._tail is None:
            self._tail = self._zeros_tail()
        tb_state = self._tb_state if self._use_tb else None
        (out, valid, self._lock, self._fallback, self._expected_no, acct,
         tb_state, tb_out, self._tail) = self._step_tc(
            self._tail, chunk, self._lock, self._fallback,
            self._expected_no, tb_state)
        if self._use_tb:
            self._tb_state = tb_state
        return out, valid, acct, tb_out

    def process(self, chunk: np.ndarray):
        """One block of block_samples samples -> (RxOut, valid [F]);
        multi-frame-TB FEC sessions return a third element: a dict of
        [F]-leading arrays for TBs completed within this block
        (``valid`` marks real emissions)."""
        return self._readback(*self._dispatch(chunk))

    def _readback(self, out, valid, acct, tb_out):
        # ONE device->host copy carries everything the host loop needs
        # per block; the
        # per-frame masks are cached on the session
        # (last_valid/last_header_ok/last_crc_ok) so consumers don't
        # re-fetch out.header_ok / out.crc_ok.
        F = self.F
        a = np.asarray(acct)
        self.n_lost += int(a[0])
        self.n_frames += int(a[0]) + int(a[1])
        valid = a[2: 2 + F].astype(bool).view(BlockMasks)
        valid.header_ok = a[2 + F: 2 + 2 * F].astype(bool)
        valid.crc_ok = a[2 + 2 * F: 2 + 3 * F].astype(bool)
        self.last_valid = valid
        self.last_header_ok = valid.header_ok
        self.last_crc_ok = valid.crc_ok
        if self.probe is not None:
            ok = valid.header_ok & valid
            msgs = self._mon.eq_messages(out, self.lost_frame_rate)
            for i in np.nonzero(ok)[0]:
                self.probe.send(self._eq_builder.build(msgs[int(i)]))
        if self._use_tb:
            return out, valid, tb_out
        return out, valid

    def flush_tb(self):
        """Emit the in-progress transport block (end of stream) —
        the reference decodes its tail buffer when input ends."""
        if not self._use_tb:
            return None
        st = self._tb_state
        has = bool(st.tb_no >= 0) and bool(jnp.any(st.present))
        emitted = {
            "llrs": st.llrs[None], "cnst": st.cnst[None],
            "plen": st.plen[None], "fec_id": st.fec_id[None],
            "tb_no": st.tb_no[None],
            "valid": jnp.asarray([has]),
        }
        dec = self._flush_fn(emitted)
        from gr_dtl_jax.models import fec_chain

        self._tb_state = fec_chain.init_tb_state(self.fec)
        return {"payload": dec.payload, "payload_len": dec.payload_len,
                "crc_ok": dec.crc_ok, "fec_ok": dec.fec_ok,
                "tb_no": emitted["tb_no"], "valid": emitted["valid"]}

    @property
    def lost_frame_rate(self) -> float:
        """lost / (lost + received), as the reference equalizer reports."""
        return self.n_lost / self.n_frames if self.n_frames else 0.0


class StreamRxPipelined(StreamRx):
    """StreamRx with deferred readback — results arrive one (or more)
    blocks late, so the device->host transfer of block k's results
    overlaps block k+1's compute instead of serializing it.

    The carried DSP state (tail, trigger lock, fallback constellation,
    frame-number accounting, TB ring) chains block-to-block *on device*
    exactly as in :class:`StreamRx` — only the host readback is
    pipelined, so the demodulated output is bit-identical, shifted by
    ``depth-1`` blocks.  This is the counterpart of the reference's
    scheduler pipelining (each GR block thread overlaps its neighbours;
    here the device queue overlaps the host fetch).  The overlap bound
    is 2x StreamRx when readback latency equals per-block compute; the
    gain on the GPU is not measured.

    ``process`` returns ``None`` for the first ``depth-1`` calls, then
    block ``k-depth+1``'s results; call :meth:`drain` at end of stream.

    Args:
      depth: max dispatched-but-unread blocks (2 = classic double
        buffering; 1 = StreamRx semantics).
    """

    def __init__(self, cfg, frames_per_block: int = 16, fec=None,
                 probe=None, depth: int = 2):
        super().__init__(cfg, frames_per_block, fec, probe=probe)
        self.depth = max(1, int(depth))
        self._inflight: list[tuple] = []

    def process(self, chunk: np.ndarray):
        self._inflight.append(self._dispatch(chunk))
        if len(self._inflight) >= self.depth:
            return self._readback(*self._inflight.pop(0))
        return None

    def drain(self):
        """Fetch every still-inflight block (end of stream)."""
        res = []
        while self._inflight:
            res.append(self._readback(*self._inflight.pop(0)))
        return res


class StreamRxMega(StreamRx):
    """StreamRx with K blocks per dispatch: an in-graph ``lax.scan``
    chains the carried state (tail, trigger lock, fallback, frame
    accounting, TB ring) across K consecutive F-frame blocks inside ONE
    jitted call — one dispatch, one H2D, one readback per K blocks.

    Why: per-dispatch overhead can dominate small blocks, whose compute
    is short next to a launch and readback round trip.  The
    megastep amortizes that fixed cost over K blocks while keeping the
    SMALL block's semantics — fold vote, trigger-lock update, fallback
    constellation and loss accounting advance every F frames exactly as
    in StreamRx, so adaptation granularity is unchanged; only the
    host's dispatch/readback granularity (and therefore its buffering
    latency) grows to K*F frames.  A deployment picks (F, K) off the
    measured latency/throughput curve (tools/bench_stream.py --mega).

    :meth:`process` consumes ``K * block_samples`` samples and returns
    (RxOut [K*F, ...], valid [K*F]) (+ tb dict for W>1 FEC, leaves
    [K*F, ...]); ``last_valid``/``last_header_ok``/``last_crc_ok`` are
    [K*F].  Results are bit-identical to K successive StreamRx calls
    (tests/test_session.py::test_stream_rx_mega_matches_stream_rx).
    """

    def __init__(self, cfg, frames_per_block: int = 16,
                 blocks_per_dispatch: int = 8, fec=None, probe=None):
        super().__init__(cfg, frames_per_block, fec, probe=probe)
        self.K = int(blocks_per_dispatch)
        self.dispatch_samples = self.K * self.block_samples
        B, tl, K = self.block_samples, self.tail_len, self.K
        use_tb = self._use_tb
        step = self._step

        @jax.jit
        def mega(tail, chunk, lock_state, fallback_cnst, expected_no,
                 tb_state=None):
            samples = jnp.concatenate([tail, chunk])  # [tl + K*B]

            def body(carry, k):
                lock, fb, exp, tb = carry
                ext = jax.lax.dynamic_slice(samples, (k * B,), (tl + B,))
                out, valid, lock, fb, exp, acct, tb, tb_out = step(
                    ext, lock, fb, exp, tb)
                return (lock, fb, exp, tb), (out, valid, acct, tb_out)

            (lock, fb, exp, tb), (outs, valids, accts, tb_outs) = (
                jax.lax.scan(body,
                             (lock_state, fallback_cnst, expected_no,
                              tb_state),
                             jnp.arange(K)))
            # flatten [K, F, ...] -> [K*F, ...] so consumers see one
            # frame batch; accts pack per block for a single fetch
            flat = jax.tree.map(
                lambda a: a.reshape((a.shape[0] * a.shape[1],)
                                    + a.shape[2:]), (outs, valids))
            tb_flat = (jax.tree.map(
                lambda a: a.reshape((a.shape[0] * a.shape[1],)
                                    + a.shape[2:]), tb_outs)
                if use_tb else None)
            return (flat[0], flat[1], lock, fb, exp, accts, tb, tb_flat,
                    chunk[-tl:])

        self._mega = mega

    def _dispatch(self, chunk):
        assert chunk.shape[-1] == self.dispatch_samples, (
            f"feed exactly {self.dispatch_samples} samples per call "
            f"(K={self.K} blocks)")
        if not isinstance(chunk, jax.Array):
            chunk = self.prefetch(chunk)
        if self._tail is None:
            self._tail = self._zeros_tail()
        tb_state = self._tb_state if self._use_tb else None
        (out, valid, self._lock, self._fallback, self._expected_no, accts,
         tb_state, tb_out, self._tail) = self._mega(
            self._tail, chunk, self._lock, self._fallback,
            self._expected_no, tb_state)
        if self._use_tb:
            self._tb_state = tb_state
        return out, valid, accts, tb_out

    def _readback(self, out, valid, accts, tb_out):
        # one packed [K, 2+3F] fetch covers all K blocks' accounting
        F, K = self.F, self.K
        a = np.asarray(accts)
        self.n_lost += int(a[:, 0].sum())
        self.n_frames += int(a[:, 0].sum() + a[:, 1].sum())
        valid = a[:, 2: 2 + F].astype(bool).reshape(K * F).view(BlockMasks)
        valid.header_ok = a[:, 2 + F: 2 + 2 * F].astype(bool).reshape(K * F)
        valid.crc_ok = a[:, 2 + 2 * F: 2 + 3 * F].astype(bool).reshape(K * F)
        self.last_valid = valid
        self.last_header_ok = valid.header_ok
        self.last_crc_ok = valid.crc_ok
        if self.probe is not None:
            ok = valid.header_ok & valid
            msgs = self._mon.eq_messages(out, self.lost_frame_rate)
            for i in np.nonzero(ok)[0]:
                self.probe.send(self._eq_builder.build(msgs[int(i)]))
        if self._use_tb:
            return out, valid, tb_out
        return out, valid


class StreamTx:
    """Continuous framer/modulator: feed me PDUs, I emit sample blocks.

    Mirrors the reference TX framer's streaming contract
    (``ofdm_adaptive_frame_bb_impl.cc:176-310``): whole-PDU packing,
    empty-frame generation when idle, pacing, and MCS switching driven
    by decoded peer feedback.

    Args:
      cfg: TxConfig (``max_empty_frames``/``sample_rate`` honored).
      frames_per_block: frames modulated per jitted step.
      pace: when True, :meth:`next_block` sleeps until the block's
        wall-clock deadline at ``cfg.sample_rate`` (the reference's
        ``sleep_until`` pacing, ref :186-190).
    """

    def __init__(self, cfg, frames_per_block: int = 16, fec=None,
                 pace: bool = False, seed: int = 0):
        self.cfg = cfg
        self.F = frames_per_block
        self.fec = fec
        self.txp = transmitter.build_tx(cfg, fec)
        self.block_samples = self.F * cfg.frame_samples
        self.pace = pace
        self._queue: list[bytes] = []
        self._jumbo_rest = b""  # tail of a split jumbo PDU
        self._frame_no = 0
        self._cnst = int(cn.ConstellationType.BPSK)
        self._echo = 0
        self._empty_run = 0  # consecutive all-empty blocks emitted
        self._key = jax.random.PRNGKey(seed)
        self._deadline = None  # pacing clock
        self._maxb = (fec["max_payload_bytes"] if fec is not None
                      else cfg.max_frame_bytes())
        self._step = jax.jit(functools.partial(transmitter.tx_frames, self.txp))

    # -- control plane (reference message-port handlers) ---------------
    def send(self, pdu: bytes):
        """Queue one PDU (network packet) for transmission."""
        self._queue.append(bytes(pdu))

    def set_feedback(self, cnst_id: int):
        """Peer-requested constellation switch — the decoded
        ``feedback_constellation`` echo from the peer's headers
        (``process_feedback_header``, ref :111-130)."""
        if 1 <= int(cnst_id) <= 4:
            self._cnst = int(cnst_id)

    def set_feedback_echo(self, cnst_id: int):
        """Local RX decision to echo in outgoing headers (ref :333-336)."""
        self._echo = int(cnst_id)

    @property
    def constellation(self) -> int:
        return self._cnst

    # -- data plane -----------------------------------------------------
    def _capacity(self) -> int:
        bps = int(cn.BITS_PER_SYMBOL[self._cnst])
        if self.fec is not None:
            # FEC transport block: code-1 user bytes for this bps
            return int(self.fec["user_bytes_tab"][bps])
        return self.cfg.frame_bytes(bps) - 4  # minus CRC32

    def next_block(self):
        """Modulate one block -> (samples [block_samples] np.complex64,
        info dict) or ``None`` once the empty-frame budget is spent.

        Frames hold whole queued PDUs (jumbo PDUs split); slots with no
        data become empty frames (payload_len 0) so the stream — and the
        in-band adaptation loop — stays alive, up to
        ``cfg.max_empty_frames`` consecutive empty frames (-1 = forever,
        matching the reference default; rounded up to whole blocks since
        blocks are the emission unit).
        """
        cap = self._capacity()
        F = self.F
        frames, self._jumbo_rest = streaming.pack_pdus_budget(
            self._queue, self._jumbo_rest, cap, F)
        plen = np.array([len(f) for f in frames], np.int32)
        payload = np.zeros((len(frames), cap), np.uint8)
        for i, f in enumerate(frames):
            payload[i, : len(f)] = np.frombuffer(f, np.uint8)
        n_data = payload.shape[0]
        if n_data == 0:
            maxe = getattr(self.cfg, "max_empty_frames", -1)
            if maxe >= 0 and self._empty_run >= maxe:
                return None  # reference framer's WORK_DONE
            self._empty_run += F
        else:
            self._empty_run = 0
        full_payload = np.zeros((F, self._maxb), np.uint8)
        full_plen = np.zeros(F, np.int32)
        full_payload[:n_data, :cap] = payload[:, :cap]
        full_plen[:n_data] = plen
        frame_nos = (self._frame_no + np.arange(F)) & 0xFFF
        self._frame_no = int((self._frame_no + F) & 0xFFF)
        self._key, sub = jax.random.split(self._key)
        out = self._step(
            jnp.asarray(full_payload),
            jnp.asarray(full_plen),
            jnp.full((F,), self._cnst, jnp.int32),
            jnp.full((F,), self._echo, jnp.int32),
            jnp.asarray(frame_nos, jnp.int32),
            sub,
        )
        if self.pace:
            rate = getattr(self.cfg, "sample_rate", 0) or 0
            if rate > 0:
                now = time.monotonic()
                if self._deadline is None:
                    self._deadline = now
                self._deadline += self.block_samples / rate
                if self._deadline > now:  # ref sleep_until :186-190
                    time.sleep(self._deadline - now)
        info = {
            "frame_no": frame_nos,
            "payload": full_payload,
            "payload_len": full_plen,
            "cnst_id": np.full(F, self._cnst, np.int32),
            "frame_bytes": np.asarray(out.frame_bytes),
            "l_total": np.asarray(out.l_total),
        }
        return np.asarray(out.samples).reshape(-1), info


class StreamBurstRx:
    """Continuous reverse-channel scanner: feed me sample chunks of the
    reverse capture, I emit every feedback burst found (0..max_bursts
    per block), each exactly once.

    The streaming counterpart of the reference's always-on feedback
    listener (``corr_est_cc`` + sliding access-code parser,
    ``ofdm_adaptive_tx.py:44-60``, ``feedback_format.cc:119-146``) —
    see ops/burst.build_stream_burst_rx for the scan design.
    """

    def __init__(self, block_samples: int, modem=None, max_bursts: int = 4,
                 threshold: float = 0.5):
        self.modem = modem if modem is not None else burst.build_burst_modem()
        fn, self.tail_len = burst.build_stream_burst_rx(
            self.modem, block_samples, max_bursts, threshold)
        self.block_samples = block_samples
        self._step = jax.jit(fn)
        self._tail = np.zeros(self.tail_len, np.complex64)

    def process(self, chunk: np.ndarray) -> burst.BurstRxOut:
        assert chunk.shape[-1] == self.block_samples, (
            f"feed exactly {self.block_samples} samples per call")
        ext = np.concatenate([self._tail, np.asarray(chunk, np.complex64)])
        out = self._step(jnp.asarray(ext))
        self._tail = np.asarray(chunk)[-self.tail_len:]
        return out


class StreamSimplex:
    """Always-on simplex modem pair over user-supplied channels.

    The streaming counterpart of models/simplex.py's in-graph session
    (ref ``ofdm_adaptive_tx``/``ofdm_adaptive_rx``, SURVEY.md #41/#42):
    node A streams OFDM frames forward and scans a continuous reverse
    capture for feedback bursts; node B demodulates frames, runs the
    MCS decision on its SNR estimates and transmits the decision as a
    burst at a random (jittered) position inside its reverse block.
    Burst loss, jitter, and noise are whatever ``channel_rev`` injects —
    the adaptation loop must survive them (the reference's burst path
    is equally lossy; TX simply keeps its MCS until a burst decodes).

    Args:
      channel_fwd/channel_rev: callables samples -> samples.
      rev_block: reverse-capture samples per step (one scan block).
    """

    def __init__(self, txcfg, rxcfg, channel_fwd, channel_rev,
                 frames_per_block: int = 8, rev_block: int = 4096,
                 seed: int = 0):
        self.tx = StreamTx(txcfg, frames_per_block)
        self.rx = StreamRx(rxcfg, frames_per_block)
        self.brx = StreamBurstRx(rev_block)
        self.modem = self.brx.modem
        self.chan_fwd = channel_fwd
        self.chan_rev = channel_rev
        self.rev_block = rev_block
        self._rng = np.random.RandomState(seed)
        self.tables = adaptive.build_mcs_tables(rxcfg)
        self._fb = adaptive.initial_state(rxcfg.initial_mcs_id)
        self._cnst_of_mcs = np.asarray(self.tables["cnst"])
        self._fec_of_mcs = np.asarray(self.tables["fec"])
        tables = self.tables

        @jax.jit
        def fb_scan(state, snrs, mask):
            def stepf(s, x):
                snr, m = x
                ns, mcs = adaptive.feedback_step(s, snr, tables)
                ns = jax.tree.map(lambda a, b: jnp.where(m, a, b), ns, s)
                return ns, jnp.where(m, mcs, s.last)

            return jax.lax.scan(stepf, state, (snrs, mask))

        self._fb_scan = fb_scan
        self._burst_fn = jax.jit(
            lambda c, f: burst.burst_tx(c, f, self.modem, pad=0))
        self._burst_len = burst.burst_wave_len(self.modem)

    def step(self):
        """One forward block + one reverse block; returns telemetry or
        None when the TX queue and empty budget are exhausted."""
        blk = self.tx.next_block()
        if blk is None:
            return None
        samples, _info = blk
        out, valid = self.rx.process(np.asarray(self.chan_fwd(samples)))
        ok = valid.header_ok & valid

        # RX node: decision on decoded frames -> feedback burst
        rev = np.zeros(self.rev_block, np.complex64)
        want = None
        if ok.any():
            self._fb, mcs_seq = self._fb_scan(
                self._fb, out.snr_db, jnp.asarray(ok))
            mcs = int(np.asarray(mcs_seq)[np.nonzero(ok)[0][-1]])
            want = (int(self._cnst_of_mcs[mcs]), int(self._fec_of_mcs[mcs]))
            wave = np.asarray(self._burst_fn(
                jnp.asarray([want[0]], jnp.int32),
                jnp.asarray([want[1]], jnp.int32)))[0]
            off = self._rng.randint(0, self.rev_block - len(wave))
            rev[off: off + len(wave)] = wave

        # TX node: scan the (lossy) reverse capture, apply the last
        # decodable burst (ref framer.process_feedback:88-109)
        bout = self.brx.process(np.asarray(self.chan_rev(rev)))
        okb = np.asarray(bout.ok)
        applied = None
        if okb.any():
            i = int(np.nonzero(okb)[0][-1])
            applied = int(np.asarray(bout.cnst_id)[i])
            self.tx.set_feedback(applied)
        return {"rx": out, "ok": ok, "want": want, "applied": applied,
                "n_bursts": int(okb.sum())}


class StreamDuplex:
    """Always-on full-duplex modem node pair over user-supplied channels.

    The streaming counterpart of models/full_duplex.py: two
    ``StreamTx``/``StreamRx`` pairs on the host, adaptation in-band via
    the header echo (SURVEY.md §3.3/3.4).  The caller supplies the two
    channel functions (e.g. ops/channel.awgn closures) so fading /
    recorded impairments can be injected per direction.

    Each :meth:`step` moves one block in both directions and applies:
      peer echo (header ``feedback_constellation``) -> local TX MCS,
      local RX SNR -> feedback decision -> local echo.
    """

    def __init__(self, cfg_tx_a, cfg_rx_a, cfg_tx_b, cfg_rx_b,
                 channel_ab, channel_ba, frames_per_block: int = 8,
                 probe_a=None, probe_b=None,
                 serialize_readback: bool = False):
        self.F = frames_per_block
        # False (default): both directions' device work is dispatched
        # before either readback, so the A->B fetch overlaps the B->A
        # compute (the StreamRxPipelined discipline applied across
        # directions).  True: readback right after each dispatch — the
        # fully serialized ordering, kept for A/B step-time measurement
        # (tools/bench_stream.py).  Outputs are bit-identical either
        # way: control (feedback echo/MCS switch) is applied after both
        # halves in both orderings, so it affects the next block only.
        self.serialize_readback = serialize_readback
        self.tx_a = StreamTx(cfg_tx_a, frames_per_block)
        self.tx_b = StreamTx(cfg_tx_b, frames_per_block)
        # per-node telemetry probes (same contract as StreamRx(probe=))
        self.rx_a = StreamRx(cfg_rx_a, frames_per_block, probe=probe_a)
        self.rx_b = StreamRx(cfg_rx_b, frames_per_block, probe=probe_b)
        self.chan_ab = channel_ab
        self.chan_ba = channel_ba
        # per-node tables: each node decides with ITS OWN ladder (the
        # configs may be asymmetric)
        self.tables_a = adaptive.build_mcs_tables(cfg_rx_a)
        self.tables_b = adaptive.build_mcs_tables(cfg_rx_b)
        self._fb_a = adaptive.initial_state(cfg_rx_a.initial_mcs_id)
        self._fb_b = adaptive.initial_state(cfg_rx_b.initial_mcs_id)

        def make_fb_scan(tables):
            @jax.jit
            def fb_scan_masked(state, snrs, mask):
                # fixed-length masked scan: invalid frames don't update
                # the decision state (avoids per-block retraces)
                def step(s, x):
                    snr, m = x
                    ns, mcs = adaptive.feedback_step(s, snr, tables)
                    ns = jax.tree.map(lambda a, b: jnp.where(m, a, b), ns, s)
                    return ns, jnp.where(m, mcs, s.last)

                return jax.lax.scan(step, state, (snrs, mask))

            return fb_scan_masked

        self._fb_scan_a = make_fb_scan(self.tables_a)
        self._fb_scan_b = make_fb_scan(self.tables_b)
        self._cnst_of_mcs_a = np.asarray(self.tables_a["cnst"])
        self._cnst_of_mcs_b = np.asarray(self.tables_b["cnst"])

    def _dispatch_half(self, tx: StreamTx, chan, rx: StreamRx):
        """TX one block through the channel and launch the RX step;
        no device->host readback of RX results happens here."""
        blk = tx.next_block()
        if blk is None:
            return None
        samples, _info = blk
        return rx._dispatch(np.asarray(chan(samples)))

    def _finish_half(self, disp, rx: StreamRx, fb_state, fb_scan):
        """Read back one direction's results and compute (not apply)
        its adaptation decisions."""
        if disp is None:
            return None, fb_state, None
        out, valid = rx._readback(*disp)[:2]
        ok = valid.header_ok & valid
        # adaptation: decisions only on decoded frames (ref: feedback
        # comes from the equalizer only when a frame was received)
        echo_mcs = None
        if ok.any():
            fb_state, mcs_seq = fb_scan(fb_state, out.snr_db, jnp.asarray(ok))
            echo_mcs = int(np.asarray(mcs_seq)[np.nonzero(ok)[0][-1]])
        # last valid decoded echo steers this node's peer
        echoes = np.asarray(out.feedback_cnst)[ok]
        peer_req = int(echoes[-1]) if echoes.size else None
        return out, fb_state, {"echo_mcs": echo_mcs, "peer_req": peer_req,
                               "n_ok": int(ok.sum())}

    def step(self):
        """One block each way; returns per-direction RxOut + telemetry
        (None once both TX queues and empty budgets are exhausted)."""
        if self.serialize_readback:
            d_b = self._dispatch_half(self.tx_a, self.chan_ab, self.rx_b)
            out_b, self._fb_b, ctl_b = self._finish_half(
                d_b, self.rx_b, self._fb_b, self._fb_scan_b)
            d_a = self._dispatch_half(self.tx_b, self.chan_ba, self.rx_a)
            out_a, self._fb_a, ctl_a = self._finish_half(
                d_a, self.rx_a, self._fb_a, self._fb_scan_a)
        else:
            # both directions in flight before either readback: the
            # B-side fetch overlaps the A-side compute (and vice versa)
            d_b = self._dispatch_half(self.tx_a, self.chan_ab, self.rx_b)
            d_a = self._dispatch_half(self.tx_b, self.chan_ba, self.rx_a)
            out_b, self._fb_b, ctl_b = self._finish_half(
                d_b, self.rx_b, self._fb_b, self._fb_scan_b)
            out_a, self._fb_a, ctl_a = self._finish_half(
                d_a, self.rx_a, self._fb_a, self._fb_scan_a)
        if out_a is None and out_b is None:
            return None
        # B's decision about the A->B link is echoed in B's headers and,
        # decoded at A, switches A's TX constellation (and vice versa).
        if ctl_b and ctl_b["echo_mcs"] is not None:
            self.tx_b.set_feedback_echo(
                int(self._cnst_of_mcs_b[ctl_b["echo_mcs"]]))
        if ctl_a and ctl_a["echo_mcs"] is not None:
            self.tx_a.set_feedback_echo(
                int(self._cnst_of_mcs_a[ctl_a["echo_mcs"]]))
        if ctl_a and ctl_a["peer_req"]:
            self.tx_a.set_feedback(ctl_a["peer_req"])
        if ctl_b and ctl_b["peer_req"]:
            self.tx_b.set_feedback(ctl_b["peer_req"])
        return {"a": out_a, "b": out_b, "ctl_a": ctl_a, "ctl_b": ctl_b}
