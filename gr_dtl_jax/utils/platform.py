"""Platform selection for the command-line tools.

A tool runs on the GPU, or on the CPU when asked to (``--cpu`` or
``RUN_MODEM_CPU=1``: demos and the test suite, with 8 virtual devices).
Without that request a missing GPU is an error, never a silent move to
the CPU: a number taken on the wrong device is worse than no number.
"""

from __future__ import annotations

import os
import subprocess
import sys

__all__ = ["select_platform", "device_summary", "card_info"]


def select_platform(force_cpu: bool = False, tool: str = "gr_dtl_jax"):
    """Return ``jax`` bound to the CPU (when forced) or to a GPU.

    On the GPU the persistent compile cache is enabled
    (utils/compile_cache).  Exits with a message when no GPU is found.
    """
    if force_cpu or os.environ.get("RUN_MODEM_CPU", "0") == "1":
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax

        jax.config.update("jax_platforms", "cpu")
        return jax
    import jax

    from gr_dtl_jax.utils.compile_cache import enable_compile_cache

    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"{tool}: no GPU found (JAX platform {platform!r}); "
                 "pass --cpu or set RUN_MODEM_CPU=1 to run on the CPU")
    enable_compile_cache()
    return jax


def device_summary() -> dict:
    """The device as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def card_info() -> str:
    """``name, power.limit`` of the first card, read by ``nvidia-smi`` in
    a child process (which never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
