"""Per-component logging registry (the reference testbed's logger analog).

Mirrors the capability of ``lib/testbed/logger.cc`` / ``logger.h``
(SURVEY.md #28): per-component named loggers sharing one sink, a
runtime global level switch over the whole registry
(``set_dtl_log_level``), and an environment kill switch
(``GR_DTL_LOG=0`` disables, like the compile-time
``DTL_LOGGING_ENABLE``).  Format includes timestamp, component and
level like the reference's spdlog pattern (logger.cc:29).
"""

from __future__ import annotations

import logging
import os
import sys
import typing as t

__all__ = ["get_logger", "set_log_level", "registry"]

_FMT = "%(asctime)s.%(msecs)03d %(process)d %(name)s:%(levelname)s %(message)s"
_DATEFMT = "%m/%d %H:%M:%S"

_registry: dict[str, logging.Logger] = {}
_handler: logging.Handler | None = None


def _sink() -> logging.Handler:
    global _handler
    if _handler is None:
        _handler = logging.StreamHandler(sys.stdout)
        _handler.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    return _handler


def get_logger(component: str) -> logging.Logger:
    """INIT_DTL_LOGGER analog: one logger per component, shared sink."""
    if component not in _registry:
        lg = logging.getLogger(f"gr_dtl_jax.{component}")
        lg.propagate = False
        lg.addHandler(_sink())
        if os.environ.get("GR_DTL_LOG", "1") == "0":
            lg.setLevel(logging.CRITICAL + 1)
        else:
            lg.setLevel(os.environ.get("GR_DTL_LOG_LEVEL", "WARNING"))
        _registry[component] = lg
    return _registry[component]


def set_log_level(level: int | str) -> None:
    """set_dtl_log_level analog: apply to every registered logger."""
    for lg in _registry.values():
        lg.setLevel(level)


def registry() -> t.Mapping[str, logging.Logger]:
    return dict(_registry)
