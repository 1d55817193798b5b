import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (an H100 for the sm_90a kernels); "
        "skipped where torch.cuda.is_available() is false")
