"""LDPC encode/decode on device.

Design note
-----------
The reference wraps gr-fec's ``cldpc`` encoder and ``awgn_bp``
belief-propagation decoder behind host loops, one codeword at a time
(``lib/dtl/ldpc_enc.cc``, ``ldpc_dec.cc``; the encoder even extracts
the internal column permutation by capturing ``print_permute()`` stdout
— ldpc_enc.cc:38-51).  Here:

- **encoding** is a GF(2) matrix multiply: a systematic generator is
  derived from the alist H once on the host (Gaussian elimination with
  column pivoting), and a whole batch of codewords is produced by one
  matmul (ops/gf2.gf2_matmul),
- **decoding** is batched sum-product BP on a padded adjacency
  structure: messages live in dense ``[B, n_checks, max_row_deg]``
  tensors, check/variable updates are gathers + reductions over the
  degree axis (max degrees here are 3/7 — tiny), iterations are a
  ``lax.scan`` with per-codeword convergence masking (the reference
  runs at most 15 iterations, ldpc_dec.cc:27, and reports the average
  used — we track the same).

Transmitted codeword layout matches the reference's transport-block
convention: ``[check bits | systematic bits]`` (tb_encoder.cc:65-70).
LLR sign convention: LLR > 0 <=> bit = 0 (the reference negates LLRs
for gr-fec's opposite convention, ldpc_dec.cc:65 — ours needs no flip).
Shortened bits are pinned with LLR = +15 (|SHORTENED_VALUE| of
tb_decoder.cc:145, sign adapted to our convention).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.ops import gf2

__all__ = ["build_ldpc", "encode", "decode", "decode_mm",
           "decode_mm_twopass", "SHORTENED_LLR", "BP_PRECISION",
           "build_ldpc_bank", "encode_bank", "decode_bank",
           "decode_bank_mm"]

SHORTENED_LLR = 15.0

# precision of decode_mm's message matmuls (LLR sums and log-magnitude
# leave-one-out sums); the 0/1 syndrome and sign-count matmuls are exact
# at DEFAULT either way.  Checked against the float64 gather-form decode
# on the card by chip_smoke.py's reference phase: at DEFAULT (TF32 on
# the GPU) the hard decisions matched but iteration counts drifted by 2,
# past the +-1 tolerance, so the messages run at full float32.
BP_PRECISION = jax.lax.Precision.HIGHEST


def _gf2_solve_systematic(H: np.ndarray):
    """Column-permute H and reduce so H_perm = [A | I_M] (systematic form).

    Returns (col_perm [N], A [M, K]) with K = N - M, such that for the
    permuted codeword c = [s | p] (systematic s, parity p):
    p = A @ s (mod 2).
    """
    H = H.copy().astype(np.uint8)
    M, N = H.shape
    K = N - M
    perm = np.arange(N)
    # eliminate to put an identity in the last M (permuted) columns;
    # pivot for row r targets permuted column K + r
    for r in range(M):
        target = K + r
        # find a pivot row >= r with a 1 in some unused column; prefer
        # current target column, else swap a column in
        pivot_row = None
        for c_idx in range(target, N):
            rows = np.nonzero(H[r:, perm[c_idx]])[0]
            if rows.size:
                pivot_row = r + rows[0]
                perm[[target, c_idx]] = perm[[c_idx, target]]
                break
        if pivot_row is None:
            # look among earlier columns (rare; rank deficiency would fail)
            for c_idx in range(0, target):
                rows = np.nonzero(H[r:, perm[c_idx]])[0]
                if rows.size:
                    pivot_row = r + rows[0]
                    perm[[target, c_idx]] = perm[[c_idx, target]]
                    break
        assert pivot_row is not None, "H is rank deficient"
        if pivot_row != r:
            H[[r, pivot_row]] = H[[pivot_row, r]]
        col = perm[target]
        # clear the column everywhere else
        rows = np.nonzero(H[:, col])[0]
        for rr in rows:
            if rr != r:
                H[rr] ^= H[r]
    A = H[:, perm[:K]].copy()
    return perm, A


def build_ldpc(H: np.ndarray):
    """Precompute encoder/decoder constants from a parity-check matrix.

    Transmitted layout: cw = [parity (M) | systematic (K)] in the
    *original* H column order given by the derived permutation —
    self-consistent between encode() and decode().
    """
    H = np.asarray(H, dtype=np.uint8)
    M, N = H.shape
    K = N - M
    perm, A = _gf2_solve_systematic(H)

    # transmitted index: position j of the tx codeword corresponds to
    # H column tx_cols[j]
    tx_cols = np.concatenate([perm[K:], perm[:K]])  # [parity | systematic]
    # H in transmitted order:
    Ht = H[:, tx_cols]

    max_row = int(Ht.sum(axis=1).max())
    max_col = int(Ht.sum(axis=0).max())
    chk_adj = np.full((M, max_row), -1, dtype=np.int32)
    for r in range(M):
        cols = np.nonzero(Ht[r])[0]
        chk_adj[r, : cols.size] = cols
    # var -> (check, slot) edge map
    var_edges = np.full((N, max_col, 2), -1, dtype=np.int32)
    var_deg = np.zeros(N, dtype=np.int32)
    for r in range(M):
        for s, c in enumerate(chk_adj[r]):
            if c >= 0:
                var_edges[c, var_deg[c]] = (r, s)
                var_deg[c] += 1

    # flat edge list + dense incidence matrices for the matmul-form BP
    # (decode_mm): edge e has endpoints (edge_chk[e], edge_var[e])
    edge_chk, edge_var = np.nonzero(Ht)
    E = edge_chk.size
    Vmat = np.zeros((N, E), np.float32)  # var  x edge incidence
    Cmat = np.zeros((M, E), np.float32)  # check x edge incidence
    Vmat[edge_var, np.arange(E)] = 1.0
    Cmat[edge_chk, np.arange(E)] = 1.0

    return {
        "M": M, "N": N, "K": K,
        "A": A.astype(np.float32),  # [M, K] parity generator
        "chk_adj": chk_adj,  # [M, max_row] var index or -1
        "chk_mask": (chk_adj >= 0),
        "var_edges": var_edges,  # [N, max_col, (check, slot)]
        "var_mask": (var_edges[..., 0] >= 0),
        "Ht": Ht,
        "E": E, "Vmat": Vmat, "Cmat": Cmat,
    }


def encode(msg_bits: jax.Array, code) -> jax.Array:
    """[B, K] bits -> [B, N] codeword = [parity | systematic] (one
    matmul; replaces per-codeword host encoding, ldpc_enc.cc:53-66)."""
    parity = gf2.gf2_matmul(msg_bits.astype(jnp.float32), jnp.asarray(code["A"]).T)
    return jnp.concatenate([parity, msg_bits.astype(jnp.float32)], axis=-1).astype(
        jnp.int32
    )


def decode(llr: jax.Array, code, max_iters: int = 15):
    """Batched sum-product BP.

    Args:
      llr: [B, N] float32, transmitted order ([parity | systematic]),
           LLR > 0 <=> bit 0.
    Returns (hard_bits [B, N] int32, iters_used [B] int32, ok [B] bool).
    ``iters_used`` = first iteration after which the syndrome was
    satisfied (== max_iters if never; matches the avg-iterations
    telemetry of the reference, monitor_dec_msg).
    """
    B, N = llr.shape
    chk_adj = jnp.asarray(code["chk_adj"])  # [M, R]
    chk_mask = jnp.asarray(code["chk_mask"])  # [M, R]
    var_edges = jnp.asarray(code["var_edges"])  # [N, C, 2]
    var_mask = jnp.asarray(code["var_mask"])  # [N, C]
    M, R = chk_adj.shape

    safe_adj = jnp.maximum(chk_adj, 0)
    ve_chk = jnp.maximum(var_edges[..., 0], 0)  # [N, C]
    ve_slot = jnp.maximum(var_edges[..., 1], 0)

    def check_update(v2c):
        """v2c: [B, M, R] variable->check messages; returns c2v [B, M, R]."""
        t = jnp.tanh(jnp.clip(v2c, -20.0, 20.0) / 2.0)
        t = jnp.where(chk_mask[None], t, 1.0)
        prod = jnp.prod(t, axis=-1, keepdims=True)
        # leave-one-out product; guard tiny values for the division
        t_safe = jnp.where(jnp.abs(t) < 1e-12, jnp.sign(t) * 1e-12 + 1e-30, t)
        loo = prod / t_safe
        loo = jnp.clip(loo, -0.999999, 0.999999)
        return 2.0 * jnp.arctanh(loo)

    def gather_c2v_for_vars(c2v):
        """[B, M, R] -> [B, N, C]: each var's incoming check messages."""
        return c2v[:, ve_chk, ve_slot]

    # precompute reverse map: for each (m, r) edge, the (var, var_slot)
    rev = np.full((code["M"], R, 2), 0, dtype=np.int32)
    ve_np = np.asarray(code["var_edges"])
    for v in range(code["N"]):
        for s in range(ve_np.shape[1]):
            m, r = ve_np[v, s]
            if m >= 0:
                rev[m, r] = (v, s)
    rev = jnp.asarray(rev)
    rev_var, rev_slot = rev[..., 0], rev[..., 1]

    def syndrome_ok_of(total):
        hard = (total < 0).astype(jnp.int32)  # bit=1 where LLR<0
        bits_at_checks = jnp.where(chk_mask[None], hard[:, safe_adj], 0)
        return jnp.all(jnp.sum(bits_at_checks, axis=-1) % 2 == 0, axis=-1)

    def msg_update(args):
        c2v, inc, total, done = args
        # v2c = total - incoming (leave-one-out), per edge
        v2c_var = total[:, :, None] - inc  # [B, N, C]
        v2c = v2c_var[:, rev_var, rev_slot]  # [B, M, R]
        new_c2v = check_update(v2c)
        # freeze messages once converged (early-exit semantics inside a
        # fixed-length scan)
        return jnp.where(done[:, None, None], c2v, new_c2v)

    def run_iter(carry):
        c2v, iters_used, done = carry
        inc = gather_c2v_for_vars(c2v)  # [B, N, C]
        inc = jnp.where(var_mask[None], inc, 0.0)
        total = llr + jnp.sum(inc, axis=-1)  # [B, N]
        done = done | syndrome_ok_of(total)
        # skip the update in the converging iteration too (see decode_mm)
        c2v = jax.lax.cond(jnp.all(done), lambda a: a[0], msg_update,
                           (c2v, inc, total, done))
        iters_used = iters_used + (~done).astype(jnp.int32)
        return (c2v, iters_used, done)

    def body(carry, _):
        # batch-wide early exit on a scalar predicate (see decode_mm)
        return jax.lax.cond(jnp.all(carry[2]), lambda c: c, run_iter,
                            carry), None

    c2v0 = jnp.zeros((B, M, R), llr.dtype)
    iters0 = jnp.zeros((B,), jnp.int32)
    done0 = jnp.zeros((B,), bool)
    (c2v, iters_used, done), _ = jax.lax.scan(
        body, (c2v0, iters0, done0), None, length=max_iters, unroll=3
    )
    inc = gather_c2v_for_vars(c2v)
    inc = jnp.where(var_mask[None], inc, 0.0)
    total = llr + jnp.sum(inc, axis=-1)
    hard = (total < 0).astype(jnp.int32)
    ok = done | syndrome_ok_of(total)
    return hard, iters_used, ok


def decode_mm(llr: jax.Array, code, max_iters: int = 15):
    """Batched sum-product BP in matmul form.

    Same contract as :func:`decode`, different schedule: messages are a
    flat ``[B, E]`` edge tensor and every per-iteration scatter/gather of
    the adjacency-walk formulation becomes a dense 0/1 incidence-matrix
    matmul ([B,E]@[E,N], [B,N]@[N,E], [B,E]@[E,M], [B,M]@[M,E]) — for the
    codes here (E≈3N, tiny M/N) dense GEMMs instead of index walks.  The
    check-node leave-one-out product runs in log/sign domain so it, too,
    is two matmuls + elementwise.

    Numerics match :func:`decode` up to the log/exp round trip (same
    tanh clip, same 0.999999 arctanh guard); syndrome checks are exact.

    ``GR_DTL_BP_BF16=1`` runs the six incidence matmuls with
    bfloat16 inputs and float32 accumulation.  The 0/1 incidence
    matrices and sign counts are exact in bf16; only the log-magnitude
    messages lose ~8 mantissa bits, which sum-product BP tolerates
    (accuracy pinned: examples/bp_bf16_ablation.json, 0.05% FER at the
    waterfall knee).  Its speed on the GPU is not measured, so float32
    stays the default.  The syndrome check stays exact either way.
    """
    import os

    B, N = llr.shape
    bf16 = os.environ.get("GR_DTL_BP_BF16", "0") == "1"
    mdt = jnp.bfloat16 if bf16 else jnp.float32

    def mm(a, b, precision=BP_PRECISION):
        return jax.lax.dot(a.astype(mdt), b, precision=precision,
                           preferred_element_type=jnp.float32)

    def mm01(a, b):
        # 0/1 or small-integer operands: exact at DEFAULT precision
        return mm(a, b, jax.lax.Precision.DEFAULT)

    Vmat = jnp.asarray(code["Vmat"], mdt)       # [N, E]
    Cmat = jnp.asarray(code["Cmat"], mdt)       # [M, E]
    Htf = jnp.asarray(code["Ht"], mdt)          # [M, N]

    def syndrome_ok_of(total):
        hard = (total < 0).astype(jnp.float32)
        synd = mm01(hard, Htf.T)              # [B, M] (counts, exact: 0/1
        return jnp.all(synd % 2.0 == 0.0, axis=-1)  # inputs, f32 accum)

    def msg_update(args):
        c2v, total, done = args
        v2c = mm(total, Vmat) - c2v           # leave-one-out at variables
        t = jnp.tanh(jnp.clip(v2c, -20.0, 20.0) / 2.0)
        mag = jnp.log(jnp.maximum(jnp.abs(t), 1e-12))
        neg = (t < 0).astype(jnp.float32)
        sum_mag = mm(mag, Cmat.T)             # [B, M]
        sum_neg = mm01(neg, Cmat.T)
        loo_mag = mm(sum_mag, Cmat) - mag     # leave-one-out at checks
        loo_neg = mm01(sum_neg, Cmat) - neg
        sign = 1.0 - 2.0 * (loo_neg % 2.0)
        loo = jnp.clip(sign * jnp.exp(loo_mag), -0.999999, 0.999999)
        new_c2v = 2.0 * jnp.arctanh(loo)
        return jnp.where(done[:, None], c2v, new_c2v)

    def run_iter(carry):
        c2v, iters_used, done = carry         # c2v: [B, E]
        total = llr + mm(c2v, Vmat.T)         # [B, N]
        done = done | syndrome_ok_of(total)
        # if THIS syndrome check completed the batch, the message
        # update is frozen everywhere — skip its transcendental pass
        # in the same iteration, not just from the next one on
        c2v = jax.lax.cond(jnp.all(done), lambda a: a[0], msg_update,
                           (c2v, total, done))
        iters_used = iters_used + (~done).astype(jnp.int32)
        return (c2v, iters_used, done)

    def body(carry, _):
        # batch-wide early exit, matching the reference decoder's
        # convergence stop (gr-fec awgn_bp via ldpc_dec.cc:24-71): once
        # every codeword's syndrome passed, remaining scan iterations
        # reduce to a scalar-predicate branch that skips the
        # transcendental-heavy message update (tanh/log/exp/arctanh on
        # [B, E]) entirely; at operating SNR convergence takes 1-3
        # iterations.  Shortened/padded codewords hold
        # LLR=+SHORTENED_LLR everywhere => the all-zeros codeword =>
        # done at the first syndrome check, so padding never blocks the
        # exit.
        return jax.lax.cond(jnp.all(carry[2]), lambda c: c, run_iter,
                            carry), None

    c2v0 = jnp.zeros((B, int(code["E"])), jnp.float32)
    # unroll=3: the scan body is one cond'd message update — unrolling
    # trims loop overhead without changing the batch-wide early exit
    # (each unrolled iteration still skips once all syndromes pass)
    (c2v, iters_used, done), _ = jax.lax.scan(
        body, (c2v0, jnp.zeros((B,), jnp.int32), jnp.zeros((B,), bool)),
        None, length=max_iters, unroll=3)
    total = llr + mm(c2v, Vmat.T)
    hard = (total < 0).astype(jnp.int32)
    ok = done | syndrome_ok_of(total)
    return hard, iters_used, ok


def decode_mm_twopass(llr: jax.Array, code, max_iters: int = 15,
                      first: int = 3, bucket: int | None = None):
    """Straggler-scheduled BP: full-batch pass 1 with a small budget,
    then converged-first ordering and bucket-wise pass 2.

    The batch-wide early exit of :func:`decode_mm` makes ONE unconverged
    codeword force the whole ``[B, E]`` transcendental message update
    through the full budget.  Here:

    1. pass 1 runs ``first`` iterations on the full batch (at operating
       SNR most codewords converge in 1-3);
    2. codewords are ordered converged-last (a stable ``argsort`` on the
       done flag; row moves are contiguous slice-gathers, not element
       gathers) and split into static ``bucket``-sized groups;
    3. a ``lax.scan`` re-decodes each group from scratch with the full
       budget — groups of already-converged rows pass their syndrome at
       entry and skip every message update, so only straggler-bearing
       groups (a minority, sorted to the front) pay the transcendental
       loop on a ``bucket``-sized batch instead of a ``B``-sized one.

    Correct at ANY straggler fraction (every codeword is re-covered by
    some group; the sort only concentrates the work).  Semantics match
    the reference's per-codeword 15-iteration cap (ldpc_dec.cc:27) in
    budget; a pass-2 straggler restarts from its channel LLRs rather
    than continuing its pass-1 messages (restarting costs nothing when
    groups exit early, and avoids a ``[B, E]`` row gather of the
    message state, ~3x the LLR rows).

    Its speed against :func:`decode_mm` on the GPU is not measured;
    ``decode_mm`` is the production default.

    Returns the same ``(hard, iters_used, ok)`` contract as
    :func:`decode_mm`; ``iters_used`` counts pass-1 iterations plus the
    straggler's pass-2 iterations.
    """
    B, N = llr.shape
    if bucket is None:
        bucket = max(128, B // 8)
    nb = -(-B // bucket)
    pad = nb * bucket - B

    hard1, it1, done1 = decode_mm(llr, code, first)

    # converged-last stable order; padded rows (all-zero LLR = the
    # all-zeros codeword) decode instantly and sort as converged
    order = jnp.argsort(done1.astype(jnp.int32), stable=True)
    if pad:
        llr_p = jnp.concatenate(
            [llr, jnp.zeros((pad, N), llr.dtype)])
        order = jnp.concatenate(
            [order, jnp.arange(B, B + pad, dtype=order.dtype)])
    else:
        llr_p = llr
    # contiguous row moves: slice-gather per row (see ops/sync
    # extract_windows)
    llr_s = jax.vmap(
        lambda i: jax.lax.dynamic_slice(llr_p, (i, 0), (1, N))[0]
    )(order)

    def group(carry, llr_b):
        return carry, decode_mm(llr_b, code, max_iters)

    _, (hard_g, it_g, ok_g) = jax.lax.scan(
        group, 0, llr_s.reshape(nb, bucket, N))
    hard2 = hard_g.reshape(nb * bucket, N)
    it2 = it_g.reshape(nb * bucket)
    ok2 = ok_g.reshape(nb * bucket)
    # unsort: inverse permutation scatter (tiny: [B] int rows)
    inv = jnp.argsort(order)[:B]
    hard2 = jax.vmap(
        lambda i: jax.lax.dynamic_slice(hard2, (i, 0), (1, N))[0])(inv)
    it2 = it2[inv]
    ok2 = ok2[inv]

    hard = jnp.where(done1[:, None], hard1, hard2)
    iters = jnp.where(done1, it1, it1 + it2)
    ok = done1 | ok2
    return hard, iters, ok


# ---------------------------------------------------------------------------
# Code bank: several codes, per-codeword selection inside one jitted graph
# (the reference holds a 1-indexed vector of encoders/decoders and switches
# per transport block from the MCS/feedback, ldpc_enc.cc:21-30,
# ofdm_adaptive_fec_frame_bvb_impl.cc:178-201)
# ---------------------------------------------------------------------------

def build_ldpc_bank(Hs: list[np.ndarray]):
    """Stack several codes into padded constant tables.

    All codes share a padded transmitted layout
    ``[parity: Mmax | systematic: Kmax]`` (code c's real slots are
    ``parity[:M_c]`` and ``sys[:K_c]``); adjacency indices are remapped
    into that layout at build time.  Code ids are **1-based** like the
    reference's encoder vector (``ldpc_enc.cc:21-30``, index 0 =
    nullptr); row 0 of every table is a copy of code 1 so a stray id 0
    gathers something harmless.
    """
    codes = [build_ldpc(H) for H in Hs]
    C = len(codes)
    Mmax = max(c["M"] for c in codes)
    Kmax = max(c["K"] for c in codes)
    Nmax = Mmax + Kmax
    Rmax = max(c["chk_adj"].shape[1] for c in codes)
    Dmax = max(c["var_edges"].shape[1] for c in codes)

    chk_adj = np.full((C + 1, Mmax, Rmax), -1, np.int32)
    var_edges = np.full((C + 1, Nmax, Dmax, 2), -1, np.int32)
    rev = np.zeros((C + 1, Mmax, Rmax, 2), np.int32)
    A = np.zeros((C + 1, Mmax, Kmax), np.float32)
    n_tab = np.zeros(C + 1, np.int32)
    k_tab = np.zeros(C + 1, np.int32)
    m_tab = np.zeros(C + 1, np.int32)

    for ci, code in enumerate(codes, start=1):
        M, K = code["M"], code["K"]

        def remap(idx):
            # code tx position -> padded tx position
            return np.where(idx < M, idx, Mmax + (idx - M))

        ca = code["chk_adj"]
        chk_adj[ci, :M, : ca.shape[1]] = np.where(ca >= 0, remap(ca), -1)
        ve = code["var_edges"]
        for v in range(code["N"]):
            pv = int(remap(np.int64(v)))
            var_edges[ci, pv, : ve.shape[1]] = ve[v]
        # reverse map (check, slot) -> (padded var, var slot)
        for v in range(code["N"]):
            pv = int(remap(np.int64(v)))
            for s in range(ve.shape[1]):
                r, slot = ve[v, s]
                if r >= 0:
                    rev[ci, r, slot] = (pv, s)
        A[ci, :M, :K] = code["A"]
        n_tab[ci], k_tab[ci], m_tab[ci] = code["N"], code["K"], code["M"]

    # row 0 = code 1 (harmless gather target for id 0)
    chk_adj[0], var_edges[0], rev[0], A[0] = (
        chk_adj[1], var_edges[1], rev[1], A[1])
    n_tab[0], k_tab[0], m_tab[0] = n_tab[1], k_tab[1], m_tab[1]

    # per-code incidence matrices in the PADDED coordinate system, for
    # the matmul-form bank decoder (decode_bank_mm): code c's Ht remapped
    # so tx position j lands at padded slot (j if j < M_c else
    # Mmax + j - M_c); variables outside c's graph are edge-free (their
    # hard decision falls back to the channel LLR, which is pinned).
    mm = [None]
    for ci, code in enumerate(codes, start=1):
        M, K = code["M"], code["K"]
        Ht_pad = np.zeros((Mmax, Nmax), np.uint8)
        j = np.arange(code["N"])
        pj = np.where(j < M, j, Mmax + (j - M))
        Ht_pad[:M, pj] = code["Ht"]
        e_chk, e_var = np.nonzero(Ht_pad)
        E = e_chk.size
        Vm = np.zeros((Nmax, E), np.float32)
        Cm = np.zeros((Mmax, E), np.float32)
        Vm[e_var, np.arange(E)] = 1.0
        Cm[e_chk, np.arange(E)] = 1.0
        mm.append({"Vmat": Vm, "Cmat": Cm, "Ht": Ht_pad, "E": E})

    return {
        "n_codes": C, "Mmax": Mmax, "Kmax": Kmax, "Nmax": Nmax,
        "chk_adj": chk_adj, "chk_mask": chk_adj >= 0,
        "var_edges": var_edges, "var_mask": var_edges[..., 0] >= 0,
        "rev": rev, "A": A,
        "n_tab": n_tab, "k_tab": k_tab, "m_tab": m_tab,
        "codes": codes, "mm": mm,
    }


def encode_bank(msg_bits: jax.Array, code_idx: jax.Array, bank) -> jax.Array:
    """[B, Kmax] bits + [B] 1-based code ids -> [B, Nmax] padded
    codewords ``[parity: Mmax | systematic: Kmax]`` (bits beyond each
    code's K must be zero)."""
    A = jnp.asarray(bank["A"])[code_idx]  # [B, Mmax, Kmax]
    parity = (jnp.einsum("bk,bmk->bm", msg_bits.astype(jnp.float32), A)
              .astype(jnp.int32) % 2)
    return jnp.concatenate([parity, msg_bits.astype(jnp.int32)], axis=-1)


def decode_bank_mm(llr: jax.Array, code_idx: jax.Array, bank,
                   max_iters: int = 15):
    """Matmul-form BP over the code bank (the multi-code FEC path).

    Same contract as :func:`decode_bank`, different schedule: each
    code's dense incidence-matrix decode (:func:`decode_mm`) runs over
    the FULL batch with compile-time-constant matrices, and per-codeword
    outputs are selected by code id afterwards.  That spends
    ``n_codes x`` the single-code FLOPs, but every iteration is four
    [B,E]-by-[E,N]-class matmuls with zero per-codeword index walks,
    where the gather-form :func:`decode_bank` walks per-batch adjacency
    (``c2v[b_ix, ve_chk, ve_slot]``).  Use :func:`decode_bank` instead
    when the bank is large.
    """
    C = bank["n_codes"]
    outs = [decode_mm(llr, bank["mm"][ci], max_iters)
            for ci in range(1, C + 1)]
    if C == 1:
        return outs[0]
    sel = (jnp.clip(code_idx, 1, C) - 1).astype(jnp.int32)
    hard = jnp.stack([o[0] for o in outs], axis=1)  # [B, C, Nmax]
    its = jnp.stack([o[1] for o in outs], axis=1)  # [B, C]
    oks = jnp.stack([o[2] for o in outs], axis=1)
    b = jnp.arange(llr.shape[0])
    return hard[b, sel], its[b, sel], oks[b, sel]


def decode_bank(llr: jax.Array, code_idx: jax.Array, bank,
                max_iters: int = 15):
    """Batched sum-product BP with per-codeword code selection.

    Args:
      llr: [B, Nmax] float32 in the padded layout (pin unused slots to
           +SHORTENED_LLR); LLR > 0 <=> bit 0.
      code_idx: [B] int32 1-based ids into the bank.
    Returns (hard_bits [B, Nmax], iters_used [B], ok [B]) like
    :func:`decode`.
    """
    B = llr.shape[0]
    chk_adj = jnp.asarray(bank["chk_adj"])[code_idx]  # [B, M, R]
    chk_mask = jnp.asarray(bank["chk_mask"])[code_idx]
    ve = jnp.asarray(bank["var_edges"])[code_idx]  # [B, N, D, 2]
    var_mask = jnp.asarray(bank["var_mask"])[code_idx]
    rev = jnp.asarray(bank["rev"])[code_idx]  # [B, M, R, 2]
    M, R = chk_adj.shape[1:]

    safe_adj = jnp.maximum(chk_adj, 0)
    ve_chk = jnp.maximum(ve[..., 0], 0)  # [B, N, D]
    ve_slot = jnp.maximum(ve[..., 1], 0)
    rev_var, rev_slot = rev[..., 0], rev[..., 1]
    b_ix = jnp.arange(B)[:, None, None]

    def check_update(v2c):
        t = jnp.tanh(jnp.clip(v2c, -20.0, 20.0) / 2.0)
        t = jnp.where(chk_mask, t, 1.0)
        prod = jnp.prod(t, axis=-1, keepdims=True)
        t_safe = jnp.where(jnp.abs(t) < 1e-12, jnp.sign(t) * 1e-12 + 1e-30, t)
        loo = jnp.clip(prod / t_safe, -0.999999, 0.999999)
        return 2.0 * jnp.arctanh(loo)

    def syndrome_ok_of(total):
        hard = (total < 0).astype(jnp.int32)
        bits_at_checks = jnp.where(chk_mask, hard[b_ix, safe_adj], 0)
        return jnp.all(jnp.sum(bits_at_checks, axis=-1) % 2 == 0, axis=-1)

    def msg_update(args):
        c2v, inc, total, done = args
        v2c_var = total[:, :, None] - inc  # [B, N, D]
        v2c = v2c_var[b_ix, rev_var, rev_slot]  # [B, M, R]
        new_c2v = check_update(v2c)
        return jnp.where(done[:, None, None], c2v, new_c2v)

    def run_iter(carry):
        c2v, iters_used, done = carry
        inc = c2v[b_ix, ve_chk, ve_slot]  # [B, N, D]
        inc = jnp.where(var_mask, inc, 0.0)
        total = llr + jnp.sum(inc, axis=-1)
        done = done | syndrome_ok_of(total)
        # skip the update in the converging iteration too (see decode_mm)
        c2v = jax.lax.cond(jnp.all(done), lambda a: a[0], msg_update,
                           (c2v, inc, total, done))
        iters_used = iters_used + (~done).astype(jnp.int32)
        return (c2v, iters_used, done)

    def body(carry, _):
        # batch-wide early exit on a scalar predicate (see decode_mm)
        return jax.lax.cond(jnp.all(carry[2]), lambda c: c, run_iter,
                            carry), None

    c2v0 = jnp.zeros((B, M, R), jnp.float32)
    (c2v, iters_used, done), _ = jax.lax.scan(
        body, (c2v0, jnp.zeros((B,), jnp.int32), jnp.zeros((B,), bool)),
        None, length=max_iters, unroll=3)
    inc = c2v[b_ix, ve_chk, ve_slot]
    inc = jnp.where(var_mask, inc, 0.0)
    total = llr + jnp.sum(inc, axis=-1)
    hard = (total < 0).astype(jnp.int32)
    ok = done | syndrome_ok_of(total)
    return hard, iters_used, ok
