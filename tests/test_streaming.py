"""PDU packing (pdu_consumer semantics) + trigger lock state machine."""

import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.models import streaming


def test_pack_pdus_whole_boundaries():
    cap = 50
    pdus = [b"a" * 20, b"b" * 20, b"c" * 20]  # third doesn't fit frame 1
    payload, plen, bounds = streaming.pack_pdus(pdus, cap)
    assert plen.tolist() == [40, 20]
    assert bounds[0] == [(0, 20), (20, 20)]
    assert payload[0, :40].tobytes() == b"a" * 20 + b"b" * 20
    assert payload[1, :20].tobytes() == b"c" * 20


def test_pack_pdus_jumbo_split():
    cap = 50
    pdus = [b"x" * 10, b"J" * 120, b"y" * 10]
    payload, plen, bounds = streaming.pack_pdus(pdus, cap)
    # x alone, then jumbo split 50/50/20, then y
    assert plen.tolist() == [10, 50, 50, 20, 10]
    assert payload[1, :50].tobytes() == b"J" * 50
    assert payload[3, :20].tobytes() == b"J" * 20


def test_trigger_lock_and_synthesis():
    period = 1000
    # good triggers 0..4, then detector loses 3 frames, then resumes
    true_pos = np.arange(12) * period + 100
    cand = true_pos.copy()
    found = np.ones(12, bool)
    cand[5:8] = 0
    found[5:8] = False
    cand[8:] += 2  # small drift after the gap

    st = streaming.TriggerLockState(
        locked=jnp.asarray(False), expected=jnp.asarray(100),
        sync_count=jnp.asarray(0), miss_count=jnp.asarray(0),
    )
    st, (trigs, valid) = streaming.trigger_lock_scan(
        st, jnp.asarray(cand), jnp.asarray(found), period
    )
    trigs = np.asarray(trigs)
    valid = np.asarray(valid)
    # locked after 3 consistent triggers; missing ones synthesized
    np.testing.assert_array_equal(trigs[5:8], true_pos[5:8])
    assert valid[5:8].all()  # synthesized while locked
    np.testing.assert_array_equal(trigs[8:], true_pos[8:] + 2)
    assert bool(st.locked)


def test_trigger_unlock_after_misses():
    period = 1000
    cand = np.zeros(12, np.int64)
    found = np.zeros(12, bool)
    cand[:4] = np.arange(4) * period
    found[:4] = True  # lock
    st = streaming.TriggerLockState(
        locked=jnp.asarray(False), expected=jnp.asarray(0),
        sync_count=jnp.asarray(0), miss_count=jnp.asarray(0),
    )
    st, (trigs, valid) = streaming.trigger_lock_scan(
        st, jnp.asarray(cand), jnp.asarray(found), period
    )
    assert not bool(st.locked)  # 8 misses > UNLOCK_AFTER
    assert not np.asarray(valid)[-1]
