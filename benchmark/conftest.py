"""pytest settings of the benchmark's own tests (benchmark/tests/)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (an H100); each such test looks for one itself "
        "and skips without it")
