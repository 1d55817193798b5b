"""tinyllama-1.1b — llama2-arch small dense [arXiv:2401.02385; hf]."""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32_000,
    source="arXiv:2401.02385; hf",
))
