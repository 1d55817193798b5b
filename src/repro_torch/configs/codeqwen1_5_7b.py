"""codeqwen1.5-7b — qwen1.5-arch dense MHA [hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13_440,
    vocab_size=92_416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/CodeQwen1.5-7B; hf",
))
