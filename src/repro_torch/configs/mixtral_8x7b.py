"""mixtral-8x7b — sparse MoE decoder, 8 experts top-2, SWA [arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

ARCH = register(ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf",
))
