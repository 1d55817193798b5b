"""OpenCHK core: the paper's directive model as a PyTorch checkpoint API."""
