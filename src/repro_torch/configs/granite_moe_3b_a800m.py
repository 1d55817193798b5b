"""granite-moe-3b-a800m — fine-grained MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

Assignment spec: 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155,
MoE 40 experts top-8 (narrow experts, high top-k).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

ARCH = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    moe=MoEConfig(n_experts=40, top_k=8, capacity_factor=1.5),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
))
