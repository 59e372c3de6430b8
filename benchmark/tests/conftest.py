import pytest
import torch


def pytest_configure(config):
    torch.set_num_threads(2)


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA card where torch sees none (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
