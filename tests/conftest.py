"""Test config: an 8-device virtual CPU mesh by default (SURVEY.md §4.2 #5).

Env vars must be set before jax imports. ``JAX_PLATFORMS`` defaults to
``cpu``; the tests marked ``card`` run only where it names the GPU
(``JAX_PLATFORMS=cuda python -m pytest -m card tests/``) and skip elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


def to_host(tree):
    """Fetch a pytree to numpy."""
    return jax.tree.map(np.asarray, tree)


def jwrap(fn):
    """``jax.jit(fn)`` whose results come back as numpy arrays; drop-in at
    test call sites, including streaming loops that thread state back in."""
    jitted = jax.jit(fn)
    return lambda *args, **kwargs: to_host(jitted(*args, **kwargs))


def jrun(fn, *args, **kwargs):
    """One-shot ``jwrap(fn)(*args)`` for single comparisons."""
    return jwrap(fn)(*args, **kwargs)


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow (full-coverage mode)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (interpret-mode Pallas sharding, 4096-channel "
        "scale, digital modes); excluded by default so the default suite fits "
        "a CI budget — enable with --runslow or RADIOFRAME_RUNSLOW=1")
    config.addinivalue_line(
        "markers",
        "card: needs an NVIDIA GPU (compiled Triton kernels); skips elsewhere "
        "— run with JAX_PLATFORMS=cuda python -m pytest -m card tests/")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RADIOFRAME_RUNSLOW"):
        return
    skip = pytest.mark.skip(reason="slow: pass --runslow (or RADIOFRAME_RUNSLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def card():
    """The GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(42)
