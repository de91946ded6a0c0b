import contextlib
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Tests run on the single real CPU device (the dry-run subprocesses set
# their own XLA_FLAGS); keep math deterministic.
os.environ.setdefault("JAX_ENABLE_X64", "0")

import pytest  # noqa: E402  (path shim must run first)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "kernel: Pallas kernel oracle-parity tests — execute (not skip) on "
        "CPU via pl.pallas_call(interpret=True); ci.yml runs them as a "
        "dedicated step (`make test-kernels`)")
    config.addinivalue_line(
        "markers",
        "mesh: multi-device sharded-serving parity tests — execute (not "
        "skip) on CPU-only boxes: the CI `mesh` job and `make test-mesh` "
        "force XLA_FLAGS=--xla_force_host_platform_device_count=8, and "
        "the suites' subprocess drivers force it themselves so plain "
        "`make test` covers them too")
    config.addinivalue_line(
        "markers",
        "audit: static hot-path auditor suite — compiles (never executes) "
        "every serve-step cell and checks donation/gather/dtype/roofline "
        "invariants on the optimized HLO, plus the jaxlint AST pass and "
        "injected-violation regressions; the CI `audit` job and `make "
        "test-audit` run it as its own lane (mesh cells go through a "
        "subprocess that forces 8 host devices itself)")
    config.addinivalue_line(
        "markers",
        "gpu: repro_torch tests that launch the hand-written CUDA kernels; "
        "each decides inside the test whether a CUDA device is present and "
        "skips without one (run them on the card: `PYTHONPATH=src python "
        "-m pytest -q -m gpu tests/test_torch_*.py`)")


@pytest.fixture
def interpret_mode():
    """Force Pallas kernels onto the interpreter so the oracle-parity
    suites EXECUTE in CPU CI instead of skipping.

    Newer jax exposes ``pltpu.force_tpu_interpret_mode()``; older
    versions (the baked-in toolchain) do not, but every kernel wrapper in
    repro.kernels defaults ``interpret=None`` -> True on the CPU backend,
    so the fixture degrades to a no-op there — asserted by the suites
    themselves, which pass ``interpret=True`` explicitly at the kernel
    level and rely on the backend default at the ops/engine level."""
    try:
        from jax.experimental.pallas import tpu as pltpu
        cm = pltpu.force_tpu_interpret_mode()
    except (ImportError, AttributeError):
        cm = contextlib.nullcontext()
    with cm:
        yield
