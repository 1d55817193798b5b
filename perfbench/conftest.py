"""Registers the marker of the tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped where "
        "torch.cuda.is_available() is false")
