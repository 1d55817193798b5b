"""Hand-written Hopper kernels for the checkpoint hot spots (blockhash,
diffpack), each beside its plain PyTorch version."""
