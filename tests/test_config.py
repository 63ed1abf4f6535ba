"""Config defaults/overrides (mirrors qa_ofdm_adaptive_config.py:27-37)."""

import numpy as np

from gr_dtl_jax.utils import config as cfg
from gr_dtl_jax.ops.constellation import ConstellationType


def test_defaults():
    c = cfg.make_tx_config()
    assert c.fft_len == 64 and c.cp_len == 16
    assert c.n_data_carriers == 48
    assert c.pilot_carriers == (-21, -7, 7, 21)
    assert c.frame_length == 20
    assert c.sample_rate == 700000
    assert len(c.pilot_sym_scramble_seq) == 127
    assert c.frame_ofdm_symbols == 23  # 2 sync + 1 header + 20 payload
    assert c.frame_samples == 23 * 80
    assert c.frame_bytes(4) == 480


def test_json_override():
    c = cfg.make_rx_config({
        "frame_length": 10,
        "mcs": [[0.0, ["bpsk", "no_fec"]], [13.0, ["qpsk", "no_fec"]]],
        "not_a_field": 1,
    })
    assert c.frame_length == 10
    assert c.mcs[1][1][0] == ConstellationType.QPSK
    assert not hasattr(c, "not_a_field")
    c2 = cfg.make_rx_config(None, frame_length=5)
    assert c2.frame_length == 5


def test_malformed_mcs_entries():
    import pytest

    # unknown constellation name in a JSON mcs table must raise cleanly
    with pytest.raises(KeyError):
        cfg.make_tx_config({"mcs": [[0, ["qam1024", "no_fec"]]]})
    # wrong nesting shape must raise, not silently mis-parse
    with pytest.raises((ValueError, TypeError)):
        cfg.make_tx_config({"mcs": [[0, "bpsk"]]})
    # unknown keys are ignored (key-matched setattr, ref :68-89)
    c = cfg.make_tx_config({"no_such_key": 1, "cp_len": 8})
    assert c.cp_len == 8 and not hasattr(c, "no_such_key")


def test_empty_payload_crc_frame():
    """Zero-length payload frames are legal (empty keepalive frames):
    CRC32 over zero bytes round-trips."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gr_dtl_jax.models import framing
    from gr_dtl_jax.ops import gf2

    c = cfg.make_tx_config(None, frame_length=10)
    tables = gf2.make_crc_tables(gf2.CRC32_FRAME, c.max_frame_bytes())
    payload = jnp.zeros((2, c.max_frame_bytes()), jnp.uint8)
    plen = jnp.zeros(2, jnp.int32)
    frame, l_total = framing.build_frame_bytes(
        payload, plen, jax.random.PRNGKey(0), c.max_frame_bytes(), tables)
    out_payload, out_len, ok = framing.verify_frame_bytes(
        frame, l_total, tables)
    assert np.asarray(ok).all()
    assert (np.asarray(out_len) == 0).all()


def test_sync_words():
    c = cfg.OFDMConfig()
    w1 = c.sync_word1()
    w2 = c.sync_word2()
    assert w1.shape == (64,) and w2.shape == (64,)
    # word1 only on even centered carriers -> period-32 time repetition
    nz = np.nonzero(w1)[0] - 32
    assert np.all(nz % 2 == 0)
    x = np.fft.ifft(np.fft.ifftshift(w1))
    np.testing.assert_allclose(x[:32], x[32:], atol=1e-9)
    # word2 occupies all active carriers
    assert np.count_nonzero(w2) == 52
