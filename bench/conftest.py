"""Registers the marker of the benchmark's tests that need a CUDA card.
Such a test decides inside a fixture whether a card is present and skips
without one, with its reason."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on a machine without one")
