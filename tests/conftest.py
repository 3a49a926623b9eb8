"""Shared fixtures.  NOTE: no XLA_FLAGS device forcing here — tests run on
the real single CPU device; only launch/dryrun.py fabricates 512 devices."""
import numpy as np
import pytest

import jax


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (a CUDA kernel with no CPU "
        "form); skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def testbed():
    from repro.core import build_testbed
    return build_testbed()


@pytest.fixture()
def key():
    return jax.random.key(0)
