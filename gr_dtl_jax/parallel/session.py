"""Continuous sharded streaming session: the multi-device StreamRx.

The single-device :class:`gr_dtl_jax.models.session.StreamRx` is an
always-on receiver: per-block carried state (sample tail, trigger-lock
machine, expected-frame accounting, TB ring) chains across successive
``process()`` calls.  This module is its multi-device counterpart — a
re-design of the reference's always-on mode
(``python/dtl/ofdm_receiver.py:59-246``) across devices, per SURVEY.md
§7 step 5:

- **stream axis** (DP): ``n_streams`` independent adaptive-OFDM
  sessions; ALL carried state is held as ``[S, ...]`` device-resident
  arrays sharded ``P("stream")`` and chained across calls — nothing
  round-trips through the host between blocks.
- **time axis** (SP): each call's sample block is sharded into
  ``n_time`` contiguous sub-blocks.  Sub-block t needs ``tail_len``
  samples of left context (a frame can start inside the previous
  sub-block): shard 0 takes it from the carried tail state, shards
  t>0 receive it from their left neighbour with one ``ppermute``
  (overlap-save over the device interconnect) — the cross-shard equivalent of the
  single-device session's host-side tail concat.  The same ring
  delivers the LAST shard's tail to shard 0, which becomes the carried
  tail for the next call (``psum``-broadcast so the state stays
  replicated along time).

Cross-sub-block sequential control (the part a naive SPMD split gets
wrong) uses the gather-then-replicate pattern: the Schmidl-Cox fold
vote is ``psum``-ed into a global consensus; per-slot trigger
candidates (a few int32 per frame) are ``all_gather``-ed along time and
the single-device lock scan (``streaming.trigger_lock_scan``) runs
*replicated* on every shard over the full candidate list — identical
sequential semantics, negligible FLOPs — after which each shard
demodulates only its own frames.  Lost-frame accounting and TB
reassembly (both tiny sequential scans over per-frame metadata) run the
same way.  The heavy math — metric, FFT demod, equalization, soft
demap — stays fully sharded.

Parity with the single-device session is bit-level for all integer
decisions and byte-level for payloads (``tests/test_sharded_session.py``
pins N successive blocks against per-stream StreamRx).  Two documented
deviations: float metrics can differ in the last ulp (different
summation order in the psum-ed fold vote), and a *locked* trigger
synthesized far outside a sub-block is clamped to the sub-block instead
of extracted globally (pathological drift only).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from gr_dtl_jax.ops import constellation as cn, sync
from gr_dtl_jax.models import receiver, streaming

__all__ = ["ShardedStreamRx"]


class ShardedStreamRx:
    """Always-on sharded receiver over a ``(stream, time)`` mesh.

    Args:
      cfg: RxConfig.
      mesh: ``jax.sharding.Mesh`` with axes ``("stream", "time")``
        (parallel.mesh.make_mesh).
      n_streams: total independent streams (must divide by the mesh's
        stream-axis size).
      frames_per_block: frames per stream per :meth:`process` call
        (global across the time axis; must divide by ``n_time`` with a
        local quotient >= 2 so sub-blocks cover the halo).
      fec: fec_chain.build_fec table for the coded path (W>1 enables
        streaming TB reassembly, as in StreamRx).
      blocks_per_dispatch: K>1 turns the session into the sharded
        megastep (the multi-device StreamRxMega): an in-graph scan
        chains K sharded blocks per dispatch — one launch + one packed
        readback per K blocks, same per-block semantics (and the same
        per-dispatch-overhead amortization as the single-device
        megastep).
    """

    def __init__(self, cfg, mesh, n_streams: int, frames_per_block: int = 16,
                 fec=None, blocks_per_dispatch: int = 1, probe=None):
        self.cfg = cfg
        self.mesh = mesh
        # optional continuous telemetry, as on StreamRx: one
        # MonitorEqMsg per received frame of every stream per block
        # (stream-major; the wire schema has no stream field, so a
        # multi-stream deployment that needs attribution should attach
        # one session per probe endpoint)
        self.probe = probe
        self._eq_builder = None
        if probe is not None:
            from gr_dtl_jax.testbed import monitor as _mon

            self._mon = _mon
            self._eq_builder = _mon.MonitorProto(_mon.EQ_MSG)
        self.S = int(n_streams)
        self.F = int(frames_per_block)
        self.K = int(blocks_per_dispatch)
        self.n_time = int(mesh.shape["time"])
        n_stream_dev = int(mesh.shape["stream"])
        if self.S % n_stream_dev:
            raise ValueError(
                f"n_streams={self.S} must divide by the stream axis "
                f"({n_stream_dev} devices)")
        if self.F % self.n_time:
            raise ValueError(
                f"frames_per_block={self.F} must divide by the time axis "
                f"({self.n_time} devices)")
        self.F_local = self.F // self.n_time
        self.P = cfg.frame_samples
        self.block_samples = self.F * self.P          # per stream, global
        self.B_loc = self.F_local * self.P
        self.tail_len = self.P + cfg.fft_len
        if self.B_loc < self.tail_len:
            raise ValueError(
                f"local sub-block ({self.F_local} frames = {self.B_loc} "
                f"samples) must cover the halo ({self.tail_len}); raise "
                "frames_per_block or lower the time-axis size")
        self.rxp = receiver.build_rx(cfg, fec)
        self.fec = fec
        self._use_tb = fec is not None and fec["W"] > 1

        self.dispatch_samples = self.K * self.block_samples
        s_sh = NamedSharding(mesh, P("stream"))
        self._s_sh = s_sh
        # K == 1 feeds [S, block]; K > 1 feeds [S, K, block] so the
        # time axis shards each block's timeline, not the block index
        self._chunk_sh = NamedSharding(
            mesh, P("stream", "time") if self.K == 1
            else P("stream", None, "time"))

        # initial state is DEVICE-PRODUCED (a jitted initializer with
        # sharded outputs): it works unchanged when the mesh spans
        # multiple processes.  Only the sample chunks themselves arrive
        # from the host (the real ingest boundary).
        S, tl = self.S, self.tail_len

        def init_state():
            return (jnp.zeros((S, tl), jnp.complex64),
                    (jnp.zeros((S,), bool), jnp.zeros((S,), jnp.int32),
                     jnp.zeros((S,), jnp.int32), jnp.zeros((S,), jnp.int32)),
                    jnp.full((S,), int(cn.ConstellationType.BPSK),
                             jnp.int32),
                    jnp.full((S,), -1, jnp.int32))

        (self._tail, lock4, self._fallback, self._expected_no) = jax.jit(
            init_state,
            out_shardings=(s_sh, (s_sh, s_sh, s_sh, s_sh), s_sh, s_sh))()
        self._lock = streaming.TriggerLockState(*lock4)
        if self._use_tb:
            from gr_dtl_jax.models import fec_chain

            self._tb_state = self._fresh_tb_state()
            self._flush_fn = jax.jit(
                jax.vmap(lambda em: fec_chain.decode_emitted(fec, em)))
        else:
            self._tb_state = None
        # host-side per-stream accounting (mirrors StreamRx.n_lost/n_frames)
        self.n_lost = np.zeros(S, np.int64)
        self.n_frames = np.zeros(S, np.int64)
        self.last_valid = np.zeros((S, self.F), bool)
        self.last_header_ok = np.zeros((S, self.F), bool)
        self.last_crc_ok = np.zeros((S, self.F), bool)
        self._step = self._build_step()

    @staticmethod
    def _gput(x, sharding):
        """Host buffer -> sharded device array; multiprocess-safe (each
        process uploads only its addressable shards)."""
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sharding,
                                            lambda idx: x[idx])

    def _fetch(self, x):
        """Device -> host for a (possibly multi-process) global array."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            return np.asarray(multihost_utils.process_allgather(
                x, tiled=True))
        return np.asarray(x)

    def _fresh_tb_state(self):
        from gr_dtl_jax.models import fec_chain

        S = self.S

        def mk():
            one = fec_chain.init_tb_state(self.fec)
            return jax.tree.map(
                lambda a: jnp.broadcast_to(a[None], (S,) + a.shape), one)

        shape = jax.eval_shape(mk)
        return jax.jit(mk, out_shardings=jax.tree.map(
            lambda _: self._s_sh, shape))()

    # ------------------------------------------------------------------
    def _build_step(self):
        cfg, F, F_local, Pn = self.cfg, self.F, self.F_local, self.P
        B_loc, tail_len, n_time = self.B_loc, self.tail_len, self.n_time
        rxp, use_tb, fec = self.rxp, self._use_tb, self.fec
        mesh = self.mesh

        def sync_stage(ext, locked, expected, sync_count, miss_count):
            """One stream's trigger acquisition on one (stream, time)
            mesh cell.  ``ext``: [tail_len + B_loc]; local index u <->
            single-device samples coord t_idx*B_loc + u.  Extraction and
            CFO happen OUTSIDE the per-stream vmap (batch-level
            fast/slow conds, ops/sync.extract_frames_batch — a vmapped
            cond would run both branches)."""
            t_idx = jax.lax.axis_index("time")
            Pm, M = sync.timing_metric(ext, cfg.fft_len)
            # global fold vote: each shard folds its OWN B_loc metric
            # samples (disjoint cover of the single-device fold range
            # [0, F*P)); B_loc % P == 0 keeps the phase aligned
            folded = jnp.sum(M[:B_loc].reshape(F_local, Pn), axis=0)
            folded = jax.lax.psum(folded, "time")
            phase = sync.phase_from_folded(folded, Pn, cfg.cp_len)
            # per-slot candidates in LOCAL coords (slot j's search window
            # is the same plateau the single-device step sees: the left
            # context covers base - search for every local slot)
            cand_l = sync.frame_triggers(M, phase, Pn, F_local)
            lvl = M[jnp.clip(cand_l, 0, M.shape[-1] - 1)]
            found_l = lvl > 0.5
            # ---- replicated sequential control over gathered slots ----
            cand_all = jax.lax.all_gather(
                cand_l + t_idx * B_loc, "time", tiled=True)      # [F]
            found_all = jax.lax.all_gather(found_l, "time", tiled=True)
            lock = streaming.TriggerLockState(locked, expected, sync_count,
                                              miss_count)
            lock, (trig_all, valid_all) = streaming.trigger_lock_scan(
                lock, cand_all, found_all, Pn)
            lock = lock._replace(expected=lock.expected - F * Pn)
            trig_l = jax.lax.dynamic_slice(
                trig_all, (t_idx * F_local,), (F_local,)) - t_idx * B_loc
            valid_l = jax.lax.dynamic_slice(
                valid_all, (t_idx * F_local,), (F_local,))
            return Pm, trig_l, valid_l, lock

        def demod_stage(frames, valid_l, fallback, expected_no, tb_state):
            """One stream's demod + accounting over its extracted
            frames [F_local, Pn]."""
            fb = jnp.full((F_local,), fallback, jnp.int32)
            tb_out = None
            if use_tb:
                from gr_dtl_jax.models import fec_chain

                out, fec_in = receiver.rx_frames(rxp, frames,
                                                 fallback_cnst=fb,
                                                 defer_fec=True)
                ok_l = out.header_ok & valid_l
                # TB reassembly is a sequential scan over stream order:
                # gather the per-frame decoder inputs along time and run
                # it replicated (metadata is tiny; the LLR gather is
                # F x max_frame_bits per device)
                g = lambda a: jax.lax.all_gather(a, "time", tiled=True)
                st, emitted = fec_chain.tb_reassemble(
                    tb_state, g(fec_in["llrs"]), g(fec_in["tb_no"]),
                    g(fec_in["tb_offset"]), g(out.cnst_id),
                    g(fec_in["tb_payload"]), g(fec_in["fec_id"]),
                    g(ok_l), fec)
                dec = fec_chain.decode_emitted(fec, emitted)
                tb_out = {"payload": dec.payload,
                          "payload_len": dec.payload_len,
                          "crc_ok": dec.crc_ok, "fec_ok": dec.fec_ok,
                          "tb_no": emitted["tb_no"],
                          "valid": emitted["valid"]}
                tb_state = st
            else:
                out = receiver.rx_frames(rxp, frames, fallback_cnst=fb)
                ok_l = out.header_ok & valid_l
            # ---- replicated accounting over gathered metadata ---------
            meta_l = jnp.stack([out.frame_no, ok_l.astype(jnp.int32),
                                out.header_ok.astype(jnp.int32),
                                out.crc_ok.astype(jnp.int32),
                                out.cnst_id])                     # [5, F_l]
            meta = jax.lax.all_gather(meta_l, "time", axis=1, tiled=True)
            no_all, ok_all = meta[0], meta[1].astype(bool)
            new_fallback = meta[4, -1]

            def acct_step(exp, x):
                no, okf = x
                first = exp < 0
                gap = jnp.where(first, 0, (no - exp) % 4096)
                lost = jnp.where(okf, gap, 0)
                new_exp = jnp.where(okf, (no + 1) % 4096, exp)
                return new_exp, lost

            expected_no, losts = jax.lax.scan(acct_step, expected_no,
                                              (no_all, ok_all))
            acct_v = jnp.concatenate([
                jnp.stack([jnp.sum(losts), jnp.sum(ok_all.astype(jnp.int32))]),
                jax.lax.all_gather(valid_l.astype(jnp.int32), "time",
                                   tiled=True),
                meta[2], meta[3],
            ])                                                    # [2 + 3F]
            return (out, new_fallback, expected_no, acct_v,
                    tb_state, tb_out)

        s = P("stream")
        st_specs = (s, s, s, s)      # TriggerLockState leaves
        tb_in_spec = jax.tree.map(lambda _: s, self._tb_state)
        out_sp = P("stream", "time")

        tb_out_spec = (jax.tree.map(lambda _: s,
                                    {"payload": 0, "payload_len": 0,
                                     "crc_ok": 0, "fec_ok": 0, "tb_no": 0,
                                     "valid": 0})
                       if use_tb else None)

        def block_fn(chunk, tail, lock, fallback, expected_no, tb_state):
            # chunk: [S_l, B_loc] local shard of ONE block's samples;
            # ring halo: my sub-block tail -> right neighbour's left
            # context; shard 0's incoming ring value is the LAST shard's
            # tail = the carried tail for the NEXT block
            t_idx = jax.lax.axis_index("time")
            ring = jax.lax.ppermute(
                chunk[:, -tail_len:], "time",
                [(i, (i + 1) % n_time) for i in range(n_time)])
            left = jnp.where(t_idx == 0, tail, ring)
            ext = jnp.concatenate([left, chunk], axis=1)
            new_tail = jax.lax.psum(
                jnp.where(t_idx == n_time - 1, chunk[:, -tail_len:],
                          jnp.zeros_like(ring)), "time")
            # stage 1 (vmapped): metric + trigger acquisition + locks
            Pm, trig_l, valid_l, lk = jax.vmap(sync_stage)(
                ext, lock[0], lock[1], lock[2], lock[3])
            # batch-level extraction + CFO: ONE fast/slow cond for the
            # whole local batch (a per-stream vmapped cond would run
            # both branches and always pay the gather)
            S_l = ext.shape[0]
            frames = sync.extract_frames_batch(ext, trig_l, Pn)
            eps = sync.fine_cfo_batch(Pm, trig_l, cfg.cp_len, Pn)
            frames = sync.cfo_correct(
                frames.reshape(S_l * F_local, Pn), eps.reshape(-1),
                cfg.fft_len).reshape(S_l, F_local, Pn)
            # stage 2 (vmapped): demod + TB + accounting
            res = jax.vmap(
                demod_stage, in_axes=(0, 0, 0, 0,
                                      None if tb_state is None else 0),
            )(frames, valid_l, fallback, expected_no, tb_state)
            (out, new_fallback, expected_no, acct_v,
             tb_state, tb_out) = res
            return (out, valid_l, (lk.locked, lk.expected, lk.sync_count,
                                   lk.miss_count), new_fallback,
                    expected_no, tb_state, tb_out, acct_v, new_tail)

        K = self.K
        if K == 1:
            @functools.partial(
                shard_map, mesh=mesh,
                in_specs=(out_sp, s, st_specs, s, s, tb_in_spec),
                out_specs=(out_sp, out_sp, st_specs, s, s,
                           jax.tree.map(lambda _: s, self._tb_state),
                           tb_out_spec, s, s),
                check_vma=False,
            )
            def sstep(chunk, tail, lock, fallback, expected_no, tb_state):
                return block_fn(chunk, tail, lock, fallback, expected_no,
                                tb_state)

            return jax.jit(sstep)

        # sharded megastep: K blocks per dispatch, the block chain run
        # by an in-graph scan (the multi-device form of StreamRxMega —
        # one dispatch + one packed readback per K sharded blocks)
        mk_sp = P("stream", None, "time")

        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(mk_sp, s, st_specs, s, s, tb_in_spec),
            out_specs=(mk_sp, mk_sp, st_specs, s, s,
                       jax.tree.map(lambda _: s, self._tb_state),
                       tb_out_spec, s, s),
            check_vma=False,
        )
        def sstep_k(chunk, tail, lock, fallback, expected_no, tb_state):
            # chunk: [S_l, K, B_loc]
            def body(carry, ck):
                tail, lock, fb, exp, tb = carry
                (out, valid, lock, fb, exp, tb, tb_out, acct,
                 tail) = block_fn(ck, tail, lock, fb, exp, tb)
                return (tail, lock, fb, exp, tb), (out, valid, acct, tb_out)

            (tail, lock, fallback, expected_no, tb_state), ys = jax.lax.scan(
                body, (tail, lock, fallback, expected_no, tb_state),
                jnp.swapaxes(chunk, 0, 1))
            outs, valids, accts, tb_outs = ys  # leaves [K, S_l, ...]
            tr = lambda a: jnp.swapaxes(a, 0, 1)
            return (jax.tree.map(tr, outs), tr(valids), lock, fallback,
                    expected_no, tb_state,
                    (jax.tree.map(tr, tb_outs) if use_tb else None),
                    tr(accts), tail)

        return jax.jit(sstep_k)

    # ------------------------------------------------------------------
    def _dispatch(self, chunks):
        """Launch the sharded block step and chain the carried state."""
        chunks = np.ascontiguousarray(np.asarray(chunks, np.complex64))
        if chunks.shape != (self.S, self.dispatch_samples):
            raise ValueError(
                f"feed [{self.S}, {self.dispatch_samples}] samples per "
                f"call (K={self.K} blocks), got {chunks.shape}")
        if self.K > 1:
            chunks = chunks.reshape(self.S, self.K, self.block_samples)
        chunks = self._gput(chunks, self._chunk_sh)
        lock = (self._lock.locked, self._lock.expected,
                self._lock.sync_count, self._lock.miss_count)
        (out, valid, lock, self._fallback, self._expected_no,
         tb_state, tb_out, acct, self._tail) = self._step(
            chunks, self._tail, lock, self._fallback, self._expected_no,
            self._tb_state)
        self._lock = streaming.TriggerLockState(*lock)
        if self._use_tb:
            self._tb_state = tb_state
        return out, valid, acct, tb_out

    def process(self, chunks):
        """K=1: one global block of [S, block_samples] samples ->
        (RxOut [S, F, ...], valid [S, F]).  K>1 (sharded megastep): [S,
        K*block_samples] samples -> (RxOut [S, K, F, ...], valid
        [S, K*F]).  W>1 FEC sessions return a third ``tb_out`` element
        (leaves [S, F, ...] / [S, K, F, ...]).  ``last_valid`` /
        ``last_header_ok`` / ``last_crc_ok`` are [S, K*F] in frame
        order either way, from ONE packed accounting fetch."""
        out, valid, acct, tb_out = self._dispatch(chunks)
        F, K = self.F, self.K
        a = self._fetch(acct)           # [S, 2+3F] or [S, K, 2+3F]
        a = a.reshape(self.S, K, 2 + 3 * F)
        self.n_lost += a[:, :, 0].sum(axis=1).astype(np.int64)
        self.n_frames += (a[:, :, 0] + a[:, :, 1]).sum(axis=1).astype(np.int64)
        self.last_valid = (a[:, :, 2: 2 + F].astype(bool)
                           .reshape(self.S, K * F))
        self.last_header_ok = (a[:, :, 2 + F: 2 + 2 * F].astype(bool)
                               .reshape(self.S, K * F))
        self.last_crc_ok = (a[:, :, 2 + 2 * F: 2 + 3 * F].astype(bool)
                            .reshape(self.S, K * F))
        if self.probe is not None:
            import types

            ok = self.last_valid & self.last_header_ok       # [S, K*F]
            cnst = self._fetch(out.cnst_id).reshape(self.S, K * F)
            snr = self._fetch(out.snr_db).reshape(self.S, K * F)
            noise = self._fetch(out.noise_var).reshape(self.S, K * F)
            rates = self.lost_frame_rate
            for s in range(self.S):
                view = types.SimpleNamespace(
                    cnst_id=cnst[s], snr_db=snr[s], noise_var=noise[s])
                msgs = self._mon.eq_messages(view, float(rates[s]))
                for i in np.nonzero(ok[s])[0]:
                    self.probe.send(self._eq_builder.build(msgs[int(i)]))
        if self._use_tb:
            return out, self.last_valid, tb_out
        return out, self.last_valid

    def flush_tb(self):
        """Decode every stream's in-progress TB (end of stream)."""
        if not self._use_tb:
            return None
        st = self._tb_state
        has = np.asarray((st.tb_no >= 0) & jnp.any(st.present, axis=-1))
        emitted = {
            "llrs": st.llrs[:, None], "cnst": st.cnst[:, None],
            "plen": st.plen[:, None], "fec_id": st.fec_id[:, None],
            "tb_no": st.tb_no[:, None],
            "valid": jax.device_put(np.asarray(has)[:, None], self._s_sh),
        }
        dec = self._flush_fn(emitted)
        self._tb_state = self._fresh_tb_state()
        return {"payload": dec.payload, "payload_len": dec.payload_len,
                "crc_ok": dec.crc_ok, "fec_ok": dec.fec_ok,
                "tb_no": emitted["tb_no"], "valid": emitted["valid"]}

    @property
    def lost_frame_rate(self):
        """Per-stream lost/(lost+received), as StreamRx reports."""
        tot = np.maximum(self.n_frames, 1)
        return np.where(self.n_frames > 0, self.n_lost / tot, 0.0)
