"""Architecture & shape configuration system.

Every assigned architecture is a frozen :class:`ArchConfig` registered in
``ARCH_REGISTRY`` and selectable via ``--arch <id>`` in the launchers.
Each arch carries its own applicable shape set (the assignment's 4 shapes,
minus ``long_500k`` for pure full-attention archs — see DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# --------------------------------------------------------------------------- #
# Shapes
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape × step-kind) cell of the evaluation grid."""

    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int       # train/prefill: tokens processed; decode: KV-cache length
    global_batch: int


TRAIN_4K = ShapeSpec("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524_288, 1)

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPE_BY_NAME = {s.name: s for s in ALL_SHAPES}


# --------------------------------------------------------------------------- #
# Sub-configs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    every_k_layers: int = 1        # MoE MLP on layers where (i % every_k)==0
    capacity_factor: float = 1.25
    group_size: int = 256          # tokens per dispatch group (GShard grouping)
    dispatch: str = "einsum"       # "einsum" (one-hot, MXU) | "scatter" (sort)
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"            # "mamba" (SSD chunked) | "rwkv6"
    d_state: int = 16
    head_dim: int = 64             # SSD head size / rwkv head size
    expand: int = 2                # mamba inner expansion
    conv_width: int = 4            # mamba short conv
    chunk: int = 64                # chunked-scan block length


# --------------------------------------------------------------------------- #
# ArchConfig
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    d_head: Optional[int] = None   # default: d_model // n_heads
    attn_kind: str = "gqa"         # gqa | mla | none
    sliding_window: Optional[int] = None
    qkv_bias: bool = False         # qwen-style attention biases
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: repeating layer pattern, e.g. jamba ("attn","mamba"×7)
    hybrid_pattern: Optional[Tuple[str, ...]] = None

    encdec: bool = False           # whisper-style encoder-decoder
    frontend: Optional[str] = None  # "audio_stub" | "vision_stub"
    n_frontend_tokens: int = 0     # patch/frame embeddings prepended (vlm)

    rope_theta: float = 10_000.0
    use_rope: bool = True
    norm_eps: float = 1e-5
    act: str = "silu"              # mlp activation (gated)
    tie_embeddings: bool = False

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # citation tag from the assignment (source; verification tier)
    source: str = ""

    # ----------------------------------------------------------------- #

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True when long-context decode is feasible (SSM/hybrid/SWA)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def shapes(self) -> Tuple[ShapeSpec, ...]:
        """Shape cells applicable to this arch (DESIGN.md §5)."""
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.sub_quadratic:
            out.append(LONG_500K)
        return tuple(out)

    def skipped_shapes(self) -> Tuple[ShapeSpec, ...]:
        return tuple(s for s in ALL_SHAPES if s not in self.shapes())

    # approximate parameter count (for 6ND model-flops accounting) --------- #

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; ``active_only`` counts top-k experts only."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.attn_kind == "mla":
                m = self.mla
                assert m is not None
                qk = m.qk_nope_dim + m.qk_rope_dim
                p = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                p += d * (m.kv_lora_rank + m.qk_rope_dim)
                p += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                p += self.n_heads * m.v_head_dim * d
                return p
            hd = self.head_dim
            return d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

        def mlp_params(moe_layer: bool) -> int:
            dense = 3 * d * f  # gated mlp
            if not moe_layer or self.moe is None:
                return dense
            e = self.moe.top_k if active_only else self.moe.n_experts
            return e * 3 * d * f + d * self.moe.n_experts  # + router

        def ssm_params() -> int:
            s = self.ssm
            assert s is not None
            if s.kind == "rwkv6":
                # time-mix (r,k,v,g,o: 5·d²) + channel-mix (2·d·f + d²)
                return 6 * d * d + 2 * d * self.d_ff
            di = s.expand * d
            return d * 2 * di + di * s.conv_width + 2 * di * s.d_state + di * d

        total = emb
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            moe_layer = self.moe is not None and (i % self.moe.every_k_layers == 0)
            if kind == "attn":
                total += attn_params() + mlp_params(moe_layer)
            elif self.family == "ssm":
                total += ssm_params()        # rwkv: channel-mix is the FFN
            else:                            # hybrid mamba layers keep an MLP
                total += ssm_params() + mlp_params(moe_layer)
        if self.encdec:  # decoder stack w/ cross attention, same depth
            total += self.n_layers * (2 * attn_params() + mlp_params(False))
        return total

    def flops_param_count(self) -> int:
        """Active, non-input-embedding params — the N of MODEL_FLOPS=6·N·D.
        (lm_head matmul counted; input-embedding gather is not a matmul)."""
        n = self.param_count(active_only=True)
        if not self.tie_embeddings:
            n -= self.vocab_size * self.d_model
        return n

    def model_flops(self, shape: "ShapeSpec") -> float:
        """MODEL_FLOPS per executed step for the roofline's useful-work
        numerator: 6·N·D training, 2·N·D inference-forward (D = tokens)."""
        n = self.flops_param_count()
        if shape.kind == "train":
            return 6.0 * n * shape.global_batch * shape.seq_len
        if shape.kind == "prefill":
            return 2.0 * n * shape.global_batch * shape.seq_len
        return 2.0 * n * shape.global_batch        # decode: one token

    def layer_kind(self, i: int) -> str:
        if self.hybrid_pattern is None:
            return "ssm" if self.family == "ssm" else "attn"
        return self.hybrid_pattern[i % len(self.hybrid_pattern)]

    # reduced config for CPU smoke tests ---------------------------------- #

    def reduced(self) -> "ArchConfig":
        """Small same-family config: one fwd/train step runs on CPU."""
        kw = {}
        n_layers = 2
        if self.hybrid_pattern is not None:
            kw["hybrid_pattern"] = ("attn", "mamba")
            n_layers = 2
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, n_experts=4, top_k=min(2, moe.top_k), group_size=32,
                capacity_factor=2.0)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, d_state=8, head_dim=16, chunk=16)
        mla = self.mla
        if mla is not None:
            mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                            qk_rope_dim=8, v_head_dim=16)
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=128,
            vocab_size=512,
            sliding_window=32 if self.sliding_window else None,
            moe=moe,
            ssm=ssm,
            mla=mla,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
            **kw,
        )


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

ARCH_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCH_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_REGISTRY)}") from None
