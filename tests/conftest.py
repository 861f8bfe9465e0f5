import jax
import pytest

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device; only launch/dryrun.py uses 512 placeholders.

jax.config.update("jax_platform_name", "cpu")

# The pinned container image does not ship `hypothesis`; fall back to the
# deterministic sampling stub so property tests still run (see
# tests/_hypothesis_stub.py).
try:
    import hypothesis  # noqa: F401
except ImportError:
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from _hypothesis_stub import install as _install_hypothesis_stub
    _install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "tier2: sim<->serving parity / property suites, run as a separate "
        "non-blocking CI job (select with -m tier2)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (CUDA kernels have no CPU mode); skips "
        "without one (select with -m cuda)")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.key(0)
