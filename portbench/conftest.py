"""Registers the marker of the tests that need a CUDA card, for runs that
collect this folder alone."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
