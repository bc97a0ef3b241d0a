"""pytest settings of the benchmark's own tests (acmbench/tests)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; decided inside the test")
