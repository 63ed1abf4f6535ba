"""Simplex adaptive modem: MCS adaptation over a lossy burst reverse
channel converges and data flows (mirrors qa_ofdm_adaptive_txrx.py
test_002_feedback_txrx's reverse-channel round trip)."""

import jax
import numpy as np

from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.models import simplex
from gr_dtl_jax.ops.constellation import ConstellationType as C


def test_simplex_adaptation_converges():
    cfg = cfgmod.make_tx_config(None, frame_length=10)
    # forward ~22 dB pilot SNR -> should settle at 8PSK;
    # reverse channel has real noise too (bursts still decode)
    run, tables = simplex.build_simplex(cfg, noise_fwd=0.09, noise_rev=0.1)
    state = simplex.initial_simplex_state(cfg, tables)
    state, telem = run(state, jax.random.PRNGKey(0), n_rounds=40)

    tx_cnst = np.asarray(telem["tx_cnst"])
    burst_ok = np.asarray(telem["burst_ok"])
    assert burst_ok.mean() > 0.9, burst_ok  # reverse channel healthy
    assert tx_cnst[0] == int(C.BPSK)
    assert tx_cnst[-1] == int(C.PSK8), (tx_cnst, np.asarray(telem["snr_db"]))
    # forward data flows at the final MCS
    assert np.asarray(telem["crc_ok"])[-8:].all()
