"""minicpm3-4b — dense with Multi-head Latent Attention [hf:openbmb/MiniCPM3-4B; hf].

62L d_model=2560 40H d_ff=6400 vocab=73448. MLA: q_lora 768, kv_lora 256,
qk nope/rope 64/32, v_head 64 (MiniCPM3 HF config values).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, register

ARCH = register(ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=64,
    d_ff=6400,
    vocab_size=73_448,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                  qk_rope_dim=32, v_head_dim=64),
    source="hf:openbmb/MiniCPM3-4B; hf",
))
