"""Wire-format compatibility: load the reference's exact air-interface
constants from a JSON file and install them framework-wide.

This framework's default constellations and sync words are
*capability-compatible* with gr-dtl, not *wire-compatible*: the Gray
label->point layouts and the sync-word PN sequences are self-chosen
(ops/constellation.py:23-25, utils/config.py:65-92), because the
constants the reference actually transmits come out of a gr-digital
installation that does not exist on this machine —
``digital.ofdm_txrx._make_sync_word1/2`` and the
``constellation_bpsk/qpsk/8psk/16qam`` point tables
(ref ``python/dtl/ofdm_adaptive_config.py:33-36``,
``lib/dtl/constellation.cc:18-24``, ``ofdm_adaptive_utils.cc:51-61``).

This module turns that documented omission into a constants drop-in:

1. On any machine **with** GNU Radio, run
   ``tools/extract_gr_constants.py > wire_constants.json``.
2. Point a config at it (``wire_compat`` field, or call
   :func:`activate` directly) **before building any model** — jitted
   graphs capture the tables at trace time.

What switches when activated:

- ``ops/constellation`` point tables are replaced by the file's
  label->point maps; hard/soft decisions fall back to the generic
  table reductions (the closed-form slicers assume this framework's
  Gray layouts).
- ``utils/config`` sync-word makers return the file's
  frequency-domain vectors instead of the self-chosen PN.

Golden-bit tests gated on the constants file's presence live in
``tests/test_wire_compat.py``; they run automatically the day a real
extraction lands in the tree.
"""

from __future__ import annotations

import json

import numpy as np

from gr_dtl_jax.ops import constellation as cn

__all__ = ["load", "activate", "deactivate", "dump_native", "SCHEMA_KEYS"]

# constellation-type name -> id, protocol-pinned (ref constellation.cc:54-59)
_TYPE_OF_NAME = {
    "bpsk": int(cn.ConstellationType.BPSK),
    "qpsk": int(cn.ConstellationType.QPSK),
    "psk8": int(cn.ConstellationType.PSK8),
    "qam16": int(cn.ConstellationType.QAM16),
}

SCHEMA_KEYS = ("fft_len", "constellations", "sync_word1", "sync_word2")

_active: dict | None = None


def _c64(pairs) -> np.ndarray:
    a = np.asarray(pairs, np.float32)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError("expected a list of [re, im] pairs")
    return (a[:, 0] + 1j * a[:, 1]).astype(np.complex64)


def load(path: str) -> dict:
    """Load + validate a wire-constants JSON file.

    Schema::

        {"fft_len": 64,
         "constellations": {"bpsk": [[re, im] x 2], "qpsk": [... x 4],
                            "psk8": [... x 8], "qam16": [... x 16]},
         "sync_word1": [[re, im] x fft_len],   # centered freq domain
         "sync_word2": [[re, im] x fft_len]}
    """
    with open(path) as f:
        raw = json.load(f)
    for k in SCHEMA_KEYS:
        if k not in raw:
            raise ValueError(f"wire constants file missing key {k!r}")
    fft_len = int(raw["fft_len"])
    consts = {"fft_len": fft_len, "points": {}}
    missing = [n for n in _TYPE_OF_NAME if n not in raw["constellations"]]
    if missing:
        # a partial table would silently mix native and foreign labels —
        # a broken interop claim; demand the full extraction
        raise ValueError(
            "wire constants file is missing constellation entries "
            f"{missing!r}; all of {sorted(_TYPE_OF_NAME)} are required")
    for name, ty in _TYPE_OF_NAME.items():
        p = _c64(raw["constellations"][name])
        want = 1 << int(cn.BITS_PER_SYMBOL[ty])
        if p.shape != (want,):
            raise ValueError(
                f"{name}: expected {want} points, got {p.shape[0]}")
        consts["points"][ty] = p
    for k in ("sync_word1", "sync_word2"):
        w = _c64(raw[k])
        if w.shape != (fft_len,):
            raise ValueError(f"{k}: expected {fft_len} bins, got {w.shape[0]}")
        consts[k] = w
    return consts


def activate(consts_or_path) -> None:
    """Install wire constants framework-wide (call before model build)."""
    global _active
    consts = (load(consts_or_path) if isinstance(consts_or_path, str)
              else consts_or_path)
    from gr_dtl_jax.utils import config as cfgmod

    cn.set_wire_points(consts["points"])
    cfgmod.set_wire_sync_words(consts["sync_word1"], consts["sync_word2"])
    _active = consts


def deactivate() -> None:
    """Restore the framework's native constants."""
    global _active
    from gr_dtl_jax.utils import config as cfgmod

    cn.reset_points()
    cfgmod.set_wire_sync_words(None, None)
    _active = None


def dump_native(fft_len: int = 64) -> dict:
    """This framework's native constants in the wire-constants schema —
    used by the plumbing round-trip test (activating our own constants
    must be a no-op), and as a template for hand-edited files."""
    from gr_dtl_jax.utils import config as cfgmod

    def pairs(z):
        z = np.asarray(z)
        return [[float(v.real), float(v.imag)] for v in z]

    out = {"fft_len": fft_len, "constellations": {}}
    for name, ty in _TYPE_OF_NAME.items():
        n = 1 << int(cn.BITS_PER_SYMBOL[ty])
        out["constellations"][name] = pairs(cn._DEFAULT_POINTS[ty, :n])
    out["sync_word1"] = pairs(cfgmod.make_sync_word1(fft_len))
    out["sync_word2"] = pairs(cfgmod.make_sync_word2(fft_len))
    return out
