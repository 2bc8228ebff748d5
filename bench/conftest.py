"""pytest settings of the benchmark's tests: the marker of tests that need
an NVIDIA GPU (they decide in a fixture whether to skip)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (sm_90a) and nvcc; skips where there is none",
    )
