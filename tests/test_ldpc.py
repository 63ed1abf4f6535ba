"""LDPC: alist parse, systematic encode (H c = 0), BP decode with noise
and shortening (mirrors the reference's use of gr-fec awgn_bp +
tb_decoder SHORTENED_VALUE pinning)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from gr_dtl_jax.utils import alist as alist_mod
from gr_dtl_jax.ops import ldpc

REF_ALIST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "n_0100_k_0027.alist")


def _load_code():
    H = alist_mod.load_alist(REF_ALIST)
    return ldpc.build_ldpc(H), H


def test_alist_shapes():
    H = alist_mod.load_alist(REF_ALIST)
    assert H.shape == (73, 100)
    assert H.sum(axis=0).max() <= 3  # col degree from file header


def test_encode_satisfies_parity():
    code, H = _load_code()
    rng = np.random.RandomState(0)
    K = code["K"]
    msgs = rng.randint(0, 2, size=(8, K)).astype(np.float32)
    cw = np.asarray(ldpc.encode(jnp.asarray(msgs), code))
    # parity check in transmitted order
    assert ((code["Ht"] @ cw.T) % 2 == 0).all()
    # systematic part is the message
    np.testing.assert_array_equal(cw[:, code["M"]:], msgs.astype(np.int32))


def test_decode_noiseless():
    code, _ = _load_code()
    rng = np.random.RandomState(1)
    msgs = rng.randint(0, 2, size=(4, code["K"])).astype(np.float32)
    cw = np.asarray(ldpc.encode(jnp.asarray(msgs), code))
    llr = (1.0 - 2.0 * cw) * 8.0  # bit0 -> +8, bit1 -> -8
    bits, iters, ok = ldpc.decode(jnp.asarray(llr, dtype=jnp.float32), code)
    assert bool(jnp.all(ok))
    np.testing.assert_array_equal(np.asarray(bits), cw)
    assert int(jnp.max(iters)) == 0  # clean input converges immediately


def test_decode_corrects_noise():
    code, _ = _load_code()
    rng = np.random.RandomState(2)
    B = 32
    msgs = rng.randint(0, 2, size=(B, code["K"])).astype(np.float32)
    cw = np.asarray(ldpc.encode(jnp.asarray(msgs), code))
    x = 1.0 - 2.0 * cw  # BPSK
    sigma = 0.7  # ~3.1 dB Eb/N0 at rate 0.27
    y = x + sigma * rng.randn(B, code["N"])
    llr = 2.0 * y / sigma**2
    bits, iters, ok = ldpc.decode(jnp.asarray(llr, dtype=jnp.float32), code, max_iters=15)
    bits = np.asarray(bits)
    # uncoded BER at this sigma would be ~7%; BP should fix nearly all
    ber = (bits != cw).mean()
    assert ber < 0.005, ber
    assert np.asarray(ok).mean() > 0.8
    assert 0 < int(jnp.asarray(iters).max()) <= 15


def test_decode_with_shortening():
    """k' < K: unsent systematic tail pinned at +SHORTENED_LLR."""
    code, _ = _load_code()
    rng = np.random.RandomState(3)
    B, K, M = 8, code["K"], code["M"]
    k_prime = 11
    msgs = np.zeros((B, K), np.float32)
    msgs[:, :k_prime] = rng.randint(0, 2, size=(B, k_prime))
    cw = np.asarray(ldpc.encode(jnp.asarray(msgs), code))
    # transmit only [parity | first k' systematic]
    sent = np.concatenate([cw[:, :M], cw[:, M : M + k_prime]], axis=1)
    x = 1.0 - 2.0 * sent
    sigma = 0.6
    y = x + sigma * rng.randn(*x.shape)
    llr_sent = 2.0 * y / sigma**2
    llr = np.full((B, code["N"]), ldpc.SHORTENED_LLR, np.float32)
    llr[:, : M + k_prime] = llr_sent
    bits, _, ok = ldpc.decode(jnp.asarray(llr), code)
    np.testing.assert_array_equal(np.asarray(bits)[:, M : M + k_prime],
                                  msgs[:, :k_prime].astype(np.int32))

def test_decode_mm_matches_gather_form():
    """The matmul-form decoder is a schedule change, not a numerics
    change: hard bits, iteration counts and syndrome verdicts must match
    the adjacency-walk decoder on noisy input."""
    code, _ = _load_code()
    rng = np.random.RandomState(5)
    B = 48
    msgs = rng.randint(0, 2, size=(B, code["K"])).astype(np.float32)
    cw = np.asarray(ldpc.encode(jnp.asarray(msgs), code))
    y = (1.0 - 2.0 * cw) + 0.7 * rng.randn(B, code["N"])
    llr = jnp.asarray(2.0 * y / 0.49, dtype=jnp.float32)
    b1, i1, ok1 = ldpc.decode(llr, code, max_iters=15)
    b2, i2, ok2 = ldpc.decode_mm(llr, code, max_iters=15)
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(ok1), np.asarray(ok2))


def test_decode_mm_with_shortening():
    code, _ = _load_code()
    rng = np.random.RandomState(6)
    kp = code["K"] - 9  # shortened systematic length
    msgs = np.zeros((8, code["K"]), np.float32)
    msgs[:, :kp] = rng.randint(0, 2, size=(8, kp))
    cw = np.asarray(ldpc.encode(jnp.asarray(msgs), code))
    llr = (1.0 - 2.0 * cw) * 2.0 + 0.8 * rng.randn(8, code["N"])
    llr[:, code["M"] + kp:] = ldpc.SHORTENED_LLR  # pinned, never sent
    bits, _, ok = ldpc.decode_mm(jnp.asarray(llr, jnp.float32), code)
    assert bool(jnp.all(ok))
    np.testing.assert_array_equal(
        np.asarray(bits)[:, code["M"]:code["M"] + kp],
        msgs[:, :kp].astype(np.int32))


def test_decode_mm_bf16_mode_converges(monkeypatch):
    """GR_DTL_BP_BF16=1 (bf16 incidence matmuls, f32 accumulation):
    noisy codewords still decode exactly and the syndrome gate still
    rejects garbage -- the precision knob must not change decisions at
    operating SNR."""
    import os
    import numpy as np
    import jax
    import jax.numpy as jnp
    from gr_dtl_jax.ops import ldpc
    from gr_dtl_jax.utils import alist as alist_mod

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    H = alist_mod.load_alist(os.path.join(here, "examples",
                                          "n_0300_k_0152.alist"))
    code = ldpc.build_ldpc(H)
    rng = np.random.RandomState(0)
    B = 64
    msg = rng.randint(0, 2, size=(B, code["K"])).astype(np.float32)
    cws = np.asarray(ldpc.encode(jnp.asarray(msg), code))
    llr = ((1.0 - 2.0 * cws) * 4.0
           + rng.randn(B, code["N"]).astype(np.float32) * 0.8)

    hard32, it32, ok32 = ldpc.decode(jnp.asarray(llr), code, 15)
    monkeypatch.setenv("GR_DTL_BP_BF16", "1")
    hard16, it16, ok16 = ldpc.decode_mm(jnp.asarray(llr), code, 15)
    assert bool(jnp.all(ok16)), "bf16 BP failed to converge on clean noise"
    np.testing.assert_array_equal(np.asarray(hard16), cws)
    np.testing.assert_array_equal(np.asarray(hard16), np.asarray(hard32))
    # garbage must still be rejected by the exact syndrome gate
    junk = jnp.asarray(rng.randn(B, code["N"]).astype(np.float32) * 4.0)
    _, _, okj = ldpc.decode_mm(junk, code, 15)
    assert float(jnp.mean(okj.astype(jnp.float32))) < 0.1


def test_decode_mm_twopass_matches_decode_mm():
    """Two-pass straggler schedule: same ok flags and identical decoded
    messages as the batch-wide-exit decoder at every regime."""
    import os

    import jax

    from gr_dtl_jax.utils import alist as alist_mod

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    H = alist_mod.load_alist(os.path.join(here, "examples",
                                          "n_0300_k_0152.alist"))
    code = ldpc.build_ldpc(H)
    rng = np.random.RandomState(0)
    msg = rng.randint(0, 2, size=(300, code["K"])).astype(np.float32)
    cws = ldpc.encode(jnp.asarray(msg), code)
    for amp, sig in [(4.0, 0.5), (1.6, 1.0), (1.3, 1.0)]:
        llr = ((1.0 - 2.0 * cws.astype(jnp.float32)) * amp
               + jax.random.normal(jax.random.PRNGKey(2), cws.shape) * sig)
        h1, _i1, ok1 = ldpc.decode_mm(llr, code, 15)
        h2, _i2, ok2 = ldpc.decode_mm_twopass(llr, code, 15, bucket=64)
        np.testing.assert_array_equal(np.asarray(ok1), np.asarray(ok2))
        both = np.asarray(ok1)
        np.testing.assert_array_equal(
            np.asarray(h1)[:, code["M"]:][both],
            np.asarray(h2)[:, code["M"]:][both])
