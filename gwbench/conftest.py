"""pytest settings of the benchmark's own tests (``python -m pytest gwbench/tests``):
the ``card`` marker for tests that need a CUDA card. Such a test decides
inside itself whether there is one, and skips there when there is not."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips inside the test without one")
