"""rwkv6-3b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=2560 d_ff=8960 vocab=65536; head size 64 (40 wkv heads).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

ARCH = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # wkv heads = d_model / head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65_536,
    attn_kind="none",
    ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=64),
    source="arXiv:2404.05892; hf",
))
