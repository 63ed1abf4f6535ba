"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Sharding/collective tests need multiple devices, so the tests force the
CPU platform with 8 virtual devices.  The GPU runs happen separately,
through ``python chip_smoke.py`` (and ``--four-cards``) on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
# CLI tools need a GPU unless told otherwise; subprocesses spawned by
# tests must stay on the CPU platform (gr_dtl_jax.utils.platform honors
# this env override)
os.environ["RUN_MODEM_CPU"] = "1"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run tests marked slow (full gate, ~20 min)")
    parser.addoption("--rungpu", action="store_true", default=False,
                     help="run tests marked gpu (need a GPU)")


def pytest_collection_modifyitems(config, items):
    skip_slow = pytest.mark.skip(reason="slow: use --runslow")
    skip_gpu = pytest.mark.skip(reason="gpu: needs a GPU, use --rungpu")
    for item in items:
        if "slow" in item.keywords and not config.getoption("--runslow"):
            item.add_marker(skip_slow)
        if "gpu" in item.keywords and not config.getoption("--rungpu"):
            item.add_marker(skip_gpu)
