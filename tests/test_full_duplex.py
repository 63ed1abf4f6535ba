"""Full-duplex in-band adaptation: asymmetric links converge to the
right MCS in each direction (SURVEY.md §3.3/3.4)."""

import jax
import jax.numpy as jnp
import numpy as np

from gr_dtl_jax.utils import config as cfgmod
from gr_dtl_jax.models import full_duplex
from gr_dtl_jax.ops.constellation import ConstellationType as C


def test_asymmetric_convergence():
    cfg = cfgmod.make_full_duplex_config(None, frame_length=10)
    # A->B very clean (QAM16-capable), B->A noisy (QPSK-range SNR)
    # TX sample power ~ 52/64 = 0.81 with unit constellations
    # noise_ba targets ~22 dB pilot SNR -> settles at 8PSK; note the
    # reference's "normalized" QPSK (x0.5 amplitude) costs 6 dB on the
    # payload, so near-threshold QPSK frames fail CRC by design.
    run, tables = full_duplex.build_full_duplex(
        cfg, noise_ab=0.009, noise_ba=0.09
    )
    tables["decision_th"] = 5
    state = full_duplex.initial_duplex_state(cfg, tables)
    state, telem = run(state, jax.random.PRNGKey(0), n_rounds=48)

    a_tx = np.asarray(telem["a_tx_cnst"])
    b_tx = np.asarray(telem["b_tx_cnst"])
    snr_b = np.asarray(telem["snr_at_b"])
    # B's decisions about the clean A->B link drive A's TX up the ladder
    assert a_tx[0] == int(C.BPSK)
    assert a_tx[-1] == int(C.QAM16), (a_tx, snr_b)
    # A's decisions about the noisy B->A link cap B's TX
    assert b_tx[-1] in (int(C.QPSK), int(C.PSK8)), (b_tx, np.asarray(telem["snr_at_a"]))
    # data keeps flowing at the end in both directions
    assert np.asarray(telem["b_crc_ok"])[-8:].all()
    assert np.asarray(telem["a_crc_ok"])[-8:].all()


def test_fec_full_duplex_adaptation():
    """Full duplex on the LDPC transport-block path with a TWO-code MCS
    ladder: the in-band echo switches the peer's constellation AND its
    LDPC code (long header: feedback_constellation + fec_feedback,
    ref fec_frame_bvb_impl.cc:178-201)."""
    import os

    from gr_dtl_jax.utils import alist as alist_mod
    from gr_dtl_jax.models import fec_chain

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    Hs = [alist_mod.load_alist(os.path.join(here, "examples", f))
          for f in ("n_0100_k_0027.alist", "n_0300_k_0152.alist")]
    cfg = cfgmod.make_full_duplex_config(
        None, frame_length=10, fec=True,
        fec_codes=(("fec_1", "examples/n_0100_k_0027.alist"),
                   ("fec_2", "examples/n_0300_k_0152.alist")),
        mcs=((1e-308, (C.BPSK, "fec_1")), (11.0, (C.QPSK, "fec_2")),
             (16.0, (C.PSK8, "fec_2")), (21.0, (C.QAM16, "fec_2"))))
    fec = fec_chain.build_fec(cfg, Hs)
    run, tables = full_duplex.build_full_duplex(
        cfg, noise_ab=0.02, noise_ba=0.35, fec=fec)
    state = full_duplex.initial_duplex_state(cfg, tables)
    state, telem = run(state, jax.random.PRNGKey(1), n_rounds=40)

    a_tx = np.asarray(telem["a_tx_cnst"])
    b_tx = np.asarray(telem["b_tx_cnst"])
    a_fec = np.asarray(telem["a_tx_fec"])
    b_fec = np.asarray(telem["b_tx_fec"])
    # clean A->B: A's TX climbs the ladder AND switches to the rate-1/2
    # code; noisy B->A (~9 dB): B stays at BPSK with the strong code
    assert a_tx[0] == int(C.BPSK) and a_fec[0] == 1
    assert a_tx[-1] > int(C.BPSK), (a_tx, np.asarray(telem["snr_at_b"]))
    assert a_fec[-1] == 2, (a_fec,)
    assert b_tx[-1] == int(C.BPSK), (b_tx, np.asarray(telem["snr_at_a"]))
    assert b_fec[-1] == 1, (b_fec,)
    # coded frames still decode at the end of the run
    assert np.asarray(telem["b_crc_ok"])[-4:].all()
