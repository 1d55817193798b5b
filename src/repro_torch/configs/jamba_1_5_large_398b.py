"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536. Layer pattern: each
group of 8 layers = 1 attention + 7 mamba; MoE MLP every other layer.
Mamba layers use the chunked SSD formulation (TPU adaptation — DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

ARCH = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    hybrid_pattern=("attn",) + ("mamba",) * 7,
    use_rope=False,      # Jamba: no explicit positional encoding
    moe=MoEConfig(n_experts=16, top_k=2, every_k_layers=2),
    ssm=SSMConfig(kind="mamba", d_state=16, head_dim=64, expand=2,
                  conv_width=4, chunk=64),
    source="arXiv:2403.19887; hf",
))
