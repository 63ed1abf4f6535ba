"""MCS feedback decision: mirrors qa_ofdm_adaptive_feedback_decision.py:47-59
exactly (hysteresis 1 dB, 3-decision counter, SNR up/down sweep)."""

import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.models import adaptive
from gr_dtl_jax.ops.constellation import ConstellationType as C


def test_reference_decision_sequence():
    cfg = cfgmod.OFDMConfig()
    tables = adaptive.build_mcs_tables(cfg)
    tables["decision_th"] = 3
    k = 3 + 1  # decision_counter + 1

    snrs = np.array([27.0] * (k * 3 - 1) + [14.5] * (k * 3 - 1), np.float32)
    expected_mcs = (
        [1] * 3 + [2] * k + [3] * k          # up: QPSK -> PSK8 -> QAM16
        + [3] * 3 + [2] * k + [1] * k        # down: QAM16 -> PSK8 -> QPSK
    )
    state = adaptive.initial_state(1)
    _, mcs_ids = adaptive.feedback_scan(state, jnp.asarray(snrs), tables)
    # reference expectation is in constellation ids; ladder maps 1:1 here
    got_cnst = np.asarray(tables["cnst"])[np.asarray(mcs_ids)]
    want_cnst = np.asarray(tables["cnst"])[np.asarray(expected_mcs)]
    np.testing.assert_array_equal(got_cnst, want_cnst)


def test_batched_streams_independent():
    cfg = cfgmod.OFDMConfig()
    tables = adaptive.build_mcs_tables(cfg)
    tables["decision_th"] = 2
    T, S = 12, 3
    snrs = np.stack([
        np.full(T, 30.0),   # should climb to QAM16
        np.full(T, 5.0),    # should stay BPSK
        np.full(T, 15.0),   # should climb to QPSK only
    ], axis=1).astype(np.float32)
    state = adaptive.initial_state(0, (S,))
    _, mcs = adaptive.feedback_scan(state, jnp.asarray(snrs), tables)
    final = np.asarray(mcs)[-1]
    assert final[0] == 3 and final[1] == 0 and final[2] == 1
