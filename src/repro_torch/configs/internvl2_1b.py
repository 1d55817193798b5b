"""internvl2-1b — InternViT + InternLM2 VLM backbone [arXiv:2404.16821; hf].

Backbone only per the assignment: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. The InternViT frontend is a stub: ``input_specs`` supplies
patch embeddings (B, 256, d_model) prepended to text tokens; total sequence
length equals the shape's seq_len.
"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_655,
    frontend="vision_stub",
    n_frontend_tokens=256,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2404.16821; hf",
))
