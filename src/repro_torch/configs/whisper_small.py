"""whisper-small — encoder-decoder audio transformer [arXiv:2212.04356; unverified].

12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865. Conv audio frontend is
a stub per the assignment: ``input_specs`` supplies precomputed frame
embeddings (B, T, d_model).
"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    encdec=True,
    frontend="audio_stub",
    act="gelu",
    use_rope=False,
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
))
