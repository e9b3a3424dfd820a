import os
import sys

# src-layout import path (tests run as `PYTHONPATH=src pytest tests/`, but
# make it work without the env var too)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# hypothesis is optional: without it, property-based tests degrade to a
# single run on each strategy's canonical example instead of breaking
# collection of every module that imports it.
try:
    import hypothesis  # noqa: F401
except ImportError:
    from _hypothesis_stub import install as _install_hypothesis_stub

    _install_hypothesis_stub()

# NOTE: do NOT set --xla_force_host_platform_device_count here; smoke tests
# and benches must see the single real device (only dryrun.py forces 512).
# Multi-device sharding tests instead run their bodies in a subprocess via
# the `run_sharded` fixture below, where the flag can be set before jax
# initialises.

import subprocess

import pytest


@pytest.fixture
def run_sharded():
    """Run a python snippet in a subprocess with 8 forced host devices.

    Returns a callable: ``run_sharded(code, n_devices=8) -> stdout``.
    Asserts the child exits 0 (its stderr is surfaced in the assertion
    message), so test bodies just print what they want to check.
    """
    root = os.path.join(os.path.dirname(__file__), "..")

    def run(code: str, n_devices: int = 8) -> str:
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={n_devices}")
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.path.join(root, "src")
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, cwd=root,
                              timeout=600)
        assert proc.returncode == 0, (
            f"sharded subprocess failed (rc={proc.returncode})\n"
            f"--- stdout ---\n{proc.stdout}\n"
            f"--- stderr ---\n{proc.stderr}")
        return proc.stdout

    return run


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips where there is none); "
        "run on the card with `python -m pytest -m gpu tests/`")
