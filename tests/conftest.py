import os
import sys

# Tests must see the default single host device (the dry-run sets its own
# XLA_FLAGS in a separate process); never leak a device-count override here.
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess checks (minutes)")
    config.addinivalue_line(
        "markers", "chaos: elastic-training chaos scenarios (subprocess, "
        "virtual devices) — excluded from the tier-1 fast path; run with "
        "'pytest -m chaos' or scripts/check.sh's chaos-gate")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels have "
        "no CPU mode); skips without one — run on the card with "
        "'pytest -m cuda tests/test_torch_*.py'")


def pytest_collection_modifyitems(config, items):
    # chaos scenarios stay out of the tier-1 fast path: they only run when
    # selected explicitly (-m chaos) or by the CI chaos-gate (RUN_CHAOS=1)
    markexpr = config.getoption("-m", default="") or ""
    if "chaos" in markexpr or os.environ.get("RUN_CHAOS"):
        return
    skip = pytest.mark.skip(
        reason="chaos scenario: run with -m chaos (check.sh chaos-gate)")
    for item in items:
        if "chaos" in item.keywords:
            item.add_marker(skip)


@pytest.fixture()
def key():
    return jax.random.PRNGKey(0)
