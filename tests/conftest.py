"""Test bootstrap: fall back to the vendored deterministic hypothesis shim
(tests/_stubs/) when the real package is absent -- the container has no
network, and property tests degrade gracefully to seeded random sampling."""

import os
import sys

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "_stubs"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
