"""gr_dtl_jax — an adaptive-OFDM modem framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
GNU Radio module gr-dtl (adaptive OFDM modem with SNR-driven MCS adaptation,
LDPC transport-block FEC, CRC-gated framing, telemetry and a packet
convergence layer).  Instead of a thread-per-block streaming scheduler the
framework is a block-batched, fused, jitted dataflow: frames are arrays,
per-stream DSP state is carried through ``lax.scan`` and many independent
streams (or time-blocks of one stream) are sharded over a device mesh.

Layer map (mirrors SURVEY.md §7):

- :mod:`gr_dtl_jax.utils`    — config, frame metadata struct, alist loader,
  logging (ref L0'/testbed support).
- :mod:`gr_dtl_jax.ops`      — pure DSP kernels: GF(2)/CRC, constellations,
  bit repack, OFDM mod/demod, Schmidl-Cox sync, channel estimation,
  equalizer, LDPC, channel models (ref L1').
- :mod:`gr_dtl_jax.models`   — chain compositions: transmitter, receiver,
  full-duplex modem, adaptive MCS control (ref L4 python layer).
- :mod:`gr_dtl_jax.parallel` — mesh/sharding layer: channel-axis pjit,
  time-block halo exchange (replaces the GNU Radio scheduler).
- :mod:`gr_dtl_jax.testbed`  — telemetry (protobuf/ZMQ), frame store,
  packet validators / convergence layer (ref L1 testbed).
"""

__version__ = "0.1.0"

from gr_dtl_jax.utils.config import (  # noqa: F401
    OFDMConfig,
    make_tx_config,
    make_rx_config,
    make_full_duplex_config,
)
from gr_dtl_jax.ops.constellation import ConstellationType  # noqa: F401
