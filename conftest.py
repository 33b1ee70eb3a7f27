"""Repository-wide pytest hooks: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA CUDA device and nvcc (skips where there is none)")
