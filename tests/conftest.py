import numpy as np
import pytest

# NOTE: no XLA_FLAGS here on purpose — only launch/dryrun.py requests 512
# placeholder devices; tests and benchmarks must see the real device count.


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (run on the "
        "H100 with `python -m pytest -m gpu tests/test_torch_kernels.py`)")
