"""Analytic per-device cost model (flops / HBM bytes / collective wire bytes).

Why analytic: XLA's HloCostAnalysis counts a ``while`` body ONCE regardless
of trip count (verified in tests/test_roofline.py), so any scanned model —
layers, query blocks, SSM chunks, microbatches — undercounts by the trip
count. Buffer assignment (memory_analysis) is loop-correct, cost_analysis
is not. We therefore compute the roofline terms from the model's own
structure — every matmul in repro/models is enumerated here with its exact
sharded dimensions — and *calibrate* against compiled cost_analysis on
fully-unrolled small cells (§Roofline in EXPERIMENTS.md reports agreement).

Conventions:
- flops are implementation-faithful: blockwise attention computes the full
  S×S_k score matrix (no causal block skipping), SWA restricts S_k to
  window+q_block; the MODEL_FLOPS/HLO ratio then *shows* the causal 2×.
- bytes count major HBM traffic: weight reads, activation reads+writes of
  (T,d)-scale tensors, attention score round-trips, optimizer state.
- collective wire bytes use the same ring model as analyze.py.
- backward = 2× forward matmul flops; full remat adds one forward
  recompute (train multiplier 4× vs 3×).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.roofline import hw


@dataclass
class Costs:
    flops: float = 0.0            # per device
    bytes: float = 0.0            # per device HBM traffic
    wire: float = 0.0             # per device collective bytes on the wire
    grad_wire: float = 0.0        # gradient-sync wire (overlappable)
    notes: Dict[str, float] = field(default_factory=dict)
    byte_notes: Dict[str, float] = field(default_factory=dict)

    def add(self, tag: str, flops: float = 0.0, bytes_: float = 0.0,
            wire: float = 0.0, grad_wire: float = 0.0):
        self.flops += flops
        self.bytes += bytes_
        self.wire += wire
        self.grad_wire += grad_wire
        if flops:
            self.notes[tag] = self.notes.get(tag, 0.0) + flops
        if bytes_:
            self.byte_notes[tag] = self.byte_notes.get(tag, 0.0) + bytes_


@dataclass
class MeshModel:
    dp: int
    tp: int

    @property
    def chips(self) -> int:
        return self.dp * self.tp


def _div(n: int, k: int) -> bool:
    return k > 1 and n % k == 0


def _ring(nbytes: float, n: int, op: str) -> float:
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if op == "ar":
        return 2 * nbytes * frac
    if op == "ag" or op == "a2a":     # nbytes = gathered/global size
        return nbytes * frac
    if op == "rs":
        return nbytes * frac          # nbytes = input (pre-scatter) size
    if op == "cp":
        return nbytes
    raise ValueError(op)


class CellModel:
    """Per-(arch × shape × mesh × knobs) analytic cost builder."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, mesh: MeshModel,
                 *, remat: bool = True, zero1: bool = False,
                 fsdp: bool = False, q_block: int = 512,
                 causal_skip: bool = False, softmax_bytes: int = 4,
                 attn_impl: str = "blockwise",
                 grad_compress: Optional[str] = None,
                 overlap_gradsync: bool = False):
        self.cfg = cfg
        self.shape = shape
        self.m = mesh
        self.remat = remat
        self.zero1 = zero1
        self.fsdp = fsdp
        self.q_block = q_block
        self.causal_skip = causal_skip     # beyond-paper: block-skip attention
        self.softmax_bytes = softmax_bytes  # fp32 (4) or bf16 (2) score traffic
        self.attn_impl = attn_impl          # "blockwise" | "flash" (Pallas)
        self.grad_compress = grad_compress  # None | "int8"
        self.overlap_gradsync = overlap_gradsync
        self.wdt = 2 if cfg.param_dtype == "bfloat16" else 4
        self.adt = 2                        # bf16 activations
        self.train = shape.kind == "train"
        # tokens per device (per step; decode: 1 token × local batch)
        dp = mesh.dp
        if shape.kind == "decode":
            self.b_loc = max(1, shape.global_batch // dp)
            self.t_loc = self.b_loc
        else:
            self.b_loc = max(1, shape.global_batch // dp)
            self.t_loc = self.b_loc * shape.seq_len
        self.c = Costs()

    # ------------------------------------------------------------------ #
    # primitives
    # ------------------------------------------------------------------ #

    def _fwd_mult(self) -> float:
        """Train: fwd + bwd (2×) + remat refwd (1×) = 4 (3 without remat)."""
        if not self.train:
            return 1.0
        return 4.0 if self.remat else 3.0

    def matmul(self, tag: str, t: float, d_in: int, d_out: int,
               shardable: bool = True, weight: bool = True,
               mult: Optional[float] = None):
        """t local rows through a (d_in, d_out) weight, col/row TP-sharded."""
        tp = self.m.tp if shardable else 1
        mult = self._fwd_mult() if mult is None else mult
        f = 2.0 * t * d_in * d_out / tp * mult
        # weight read per pass + activation in/out
        wreads = (2 if self.train else 1)
        b = (d_in * d_out / tp) * self.wdt * wreads * (1 if weight else 0)
        b += t * d_in * self.adt * mult
        b += t * (d_out / tp) * self.adt * mult
        if self.fsdp and weight and self.train:
            # params also sharded over dp → all-gather fwd + bwd refwd
            self.c.add(tag + "/fsdp-ag", wire=_ring(
                d_in * d_out / tp * self.wdt, self.m.dp, "ag") * 2)
        self.c.add(tag, f, b)

    def tp_allreduce(self, tag: str, t: float, d: int, per_pass: int = 1):
        """Megatron row-parallel output psum: activations (t, d)."""
        if self.m.tp <= 1:
            return
        passes = (3 if self.train else 1)   # fwd + bwd(dx) + remat refwd
        if self.train and not self.remat:
            passes = 2
        self.c.add(tag, wire=_ring(t * d * self.adt, self.m.tp, "ar")
                   * per_pass * passes)

    def act_traffic(self, tag: str, t: float, d: int, n_tensors: float):
        self.c.add(tag, bytes_=t * d * self.adt * n_tensors * self._fwd_mult())

    # ------------------------------------------------------------------ #
    # components
    # ------------------------------------------------------------------ #

    def attention_layer(self, s_q: float, s_kv: float, causal: bool):
        cfg = self.cfg
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        t_q = self.b_loc * s_q
        # projections
        if cfg.attn_kind == "mla":
            m = cfg.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            self.matmul("attn/q_a", t_q, cfg.d_model, m.q_lora_rank)
            self.matmul("attn/q_b", t_q, m.q_lora_rank, h * qk)
            self.matmul("attn/kv_a", t_q, cfg.d_model,
                        m.kv_lora_rank + m.qk_rope_dim)
            self.matmul("attn/k_b", t_q, m.kv_lora_rank, h * m.qk_nope_dim)
            self.matmul("attn/v_b", t_q, m.kv_lora_rank, h * m.v_head_dim)
            self.matmul("attn/o", t_q, h * m.v_head_dim, cfg.d_model)
            dh_eff = qk
            dv_eff = m.v_head_dim
        else:
            self.matmul("attn/q", t_q, cfg.d_model, h * dh)
            self.matmul("attn/k", t_q, cfg.d_model, kv * dh)
            self.matmul("attn/v", t_q, cfg.d_model, kv * dh)
            self.matmul("attn/o", t_q, h * dh, cfg.d_model)
            dh_eff = dv_eff = dh
        self.tp_allreduce("attn/psum", t_q, cfg.d_model)

        # scores: S_kv restricted by window; causal halving only when the
        # implementation actually skips blocks (causal_skip knob)
        window = cfg.sliding_window
        if window is not None and causal and (window + self.q_block) < s_kv:
            s_eff = window + self.q_block
        else:
            s_eff = s_kv
            if causal and self.causal_skip:
                s_eff = s_kv / 2 + self.q_block / 2
        h_loc = h / self.m.tp if _div(h, self.m.tp) else h
        f = 2.0 * self.b_loc * h_loc * s_q * s_eff * (dh_eff + dv_eff)
        f *= self._fwd_mult()
        if self.attn_impl == "flash":
            # fused Pallas flash kernel (kernels/flashattn.py): score matrix
            # lives in VMEM only — no HBM round-trip
            score_b = 0.0
        else:
            # score traffic: one write + one read of (s_q, s_eff) per head
            score_b = self.b_loc * h_loc * s_q * s_eff * self.softmax_bytes * 2
            score_b *= self._fwd_mult()
        # k/v read per q block round (streaming reads)
        kv_b = (s_q / self.q_block) * self.b_loc * h_loc * s_eff * \
            2 * dh_eff * self.adt
        self.c.add("attn/scores", f, score_b + kv_b)

    def attention_decode_layer(self, s_cache: float):
        cfg = self.cfg
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        b = self.b_loc
        window = cfg.sliding_window
        s_eff = min(s_cache, window) if window else s_cache
        # cache sharding: batch over dp when divisible, else seq over dp
        if not _div(self.shape.global_batch, self.m.dp):
            s_eff = s_eff / self.m.dp
        if cfg.attn_kind == "mla":
            m = cfg.mla
            r = m.kv_lora_rank
            self.matmul("attn/q_a", b, cfg.d_model, m.q_lora_rank)
            self.matmul("attn/q_b", b, m.q_lora_rank,
                        h * (m.qk_nope_dim + m.qk_rope_dim))
            self.matmul("attn/kv_a", b, cfg.d_model, r + m.qk_rope_dim)
            self.matmul("attn/absorb", b, h * m.qk_nope_dim, r,
                        shardable=_div(h, self.m.tp), weight=False)
            h_loc = h / self.m.tp if _div(h, self.m.tp) else h
            f = 2.0 * b * h_loc * s_eff * 2 * r        # scores + out over latents
            cache_b = b * s_eff * (r + m.qk_rope_dim) * self.adt
            self.c.add("attn/latent", f, cache_b)
            self.matmul("attn/uv", b, r, h * m.v_head_dim, weight=True)
            self.matmul("attn/o", b, h * m.v_head_dim, cfg.d_model)
        else:
            self.matmul("attn/q", b, cfg.d_model, h * dh)
            self.matmul("attn/k", b, cfg.d_model, kv * dh)
            self.matmul("attn/v", b, cfg.d_model, kv * dh)
            h_loc = h / self.m.tp if _div(h, self.m.tp) else h
            f = 2.0 * b * h_loc * s_eff * 2 * dh
            cache_b = b * s_eff * (h_loc * 2) * dh * self.adt  # repeated KV read
            self.c.add("attn/cache", f, cache_b)
            self.matmul("attn/o", b, h * dh, cfg.d_model)
        self.tp_allreduce("attn/psum", b, cfg.d_model)
        if not _div(self.shape.global_batch, self.m.dp):
            # flash-decoding LSE combine over dp: (b, h) partials ×3
            self.c.add("attn/lse", wire=_ring(
                3 * b * self.cfg.n_heads * 4, self.m.dp, "ar"))

    def mlp_layer(self, t: float):
        cfg = self.cfg
        self.matmul("mlp/gate", t, cfg.d_model, cfg.d_ff)
        self.matmul("mlp/up", t, cfg.d_model, cfg.d_ff)
        self.matmul("mlp/down", t, cfg.d_ff, cfg.d_model)
        self.tp_allreduce("mlp/psum", t, cfg.d_model)

    def moe_layer(self, t: float):
        cfg = self.cfg
        m = cfg.moe
        e, k, cf, gs = m.n_experts, m.top_k, m.capacity_factor, m.group_size
        ep = _div(e, self.m.tp)
        self.matmul("moe/router", t, cfg.d_model, e, shardable=False)
        t_exp = t * k * cf
        disp_div = self.m.tp if ep else 1   # dispatch output sharded on E
        if m.dispatch == "einsum":
            cap = gs * k * cf / e
            # dispatch + combine one-hot einsums (fwd+bwd)
            f = 2.0 * t * e * cap * cfg.d_model * 2 * self._fwd_mult() / disp_div
            self.c.add("moe/dispatch", f, t * cfg.d_model * self.adt * 4)
        else:
            self.c.add("moe/dispatch",
                       bytes_=t_exp * cfg.d_model * self.adt * 4)
        if ep:
            # expert-parallel: tokens a2a to expert shards and back; each
            # EP rank runs its experts' share of the token work (÷tp)
            self.c.add("moe/a2a", wire=_ring(
                t_exp * cfg.d_model * self.adt, self.m.tp, "a2a")
                * 2 * (3 if self.train else 1))
        mult = self._fwd_mult()
        f = 2.0 * t_exp * cfg.d_model * cfg.d_ff / self.m.tp * 3 * mult
        wb = 3 * e * cfg.d_model * cfg.d_ff / (self.m.tp) * self.wdt \
            * (2 if self.train else 1)
        self.c.add("moe/experts", f, wb + t_exp * cfg.d_ff / self.m.tp
                   * self.adt * 2 * mult)
        if not ep:
            self.tp_allreduce("moe/psum", t, cfg.d_model)

    def rwkv_layer(self, t: float, decode: bool = False):
        cfg = self.cfg
        d = cfg.d_model
        hd = cfg.ssm.head_dim
        hds = d // hd
        ck = 1 if decode else cfg.ssm.chunk
        for tag in ("r", "k", "v", "g", "o"):
            self.matmul(f"rwkv/{tag}", t, d, d)
        self.matmul("rwkv/lora", t, d, 5 * 32 + 64, shardable=False)
        # wkv: intra-chunk (t × C × K) + state (K × V) terms per head
        h_loc = hds  # heads 40 not divisible by 16 → replicated (honest)
        if _div(hds, self.m.tp):
            h_loc = hds / self.m.tp
        f = (3.0 * t * ck * hd + 4.0 * t * hd * hd / max(1, hd // hd)) * h_loc
        f = f * self._fwd_mult()
        sb = t * h_loc * (ck * 4 + hd * 4) * 4      # ratio tensors fp32
        self.c.add("rwkv/wkv", f, sb)
        # channel mix
        self.matmul("rwkv/cm_k", t, d, cfg.d_ff)
        self.matmul("rwkv/cm_v", t, cfg.d_ff, d)
        self.matmul("rwkv/cm_r", t, d, d)
        self.tp_allreduce("rwkv/psum", t, d, per_pass=2)

    def mamba_layer(self, t: float, decode: bool = False):
        cfg = self.cfg
        s = cfg.ssm
        d = cfg.d_model
        di = s.expand * d
        hds = di // s.head_dim
        ck = 1 if decode else s.chunk
        self.matmul("mamba/z", t, d, di)
        self.matmul("mamba/x", t, d, di)
        self.matmul("mamba/bcdt", t, d, 2 * s.d_state + hds, shardable=False)
        self.c.add("mamba/conv", 2.0 * t * di / self.m.tp * s.conv_width
                   * self._fwd_mult(), t * di / self.m.tp * self.adt * 2)
        h_loc = hds / self.m.tp if _div(hds, self.m.tp) else hds
        # ssd: intra (C·N + C·P) + state update/out (P·N) per token per head
        f = 2.0 * t * h_loc * (ck * s.d_state + ck * s.head_dim
                               + 2 * s.head_dim * s.d_state)
        f *= self._fwd_mult()
        self.c.add("mamba/ssd", f, t * h_loc * s.head_dim * 4 * 2)
        self.matmul("mamba/out", t, di, d)
        self.tp_allreduce("mamba/psum", t, d)

    def embed_logits(self, t: float, tied: bool):
        cfg = self.cfg
        v, d = cfg.vocab_size, cfg.d_model
        # input embedding gather (+ one psum when vocab-sharded)
        self.c.add("embed/gather", bytes_=t * d * self.adt)
        if _div(v, self.m.tp):
            self.c.add("embed/psum", wire=_ring(t * d * self.adt, self.m.tp, "ar"))
        self.matmul("logits/head", t, d, v)
        # CE over vocab-sharded logits: lse partials (t,) — negligible wire
        self.c.add("logits/ce", bytes_=t * v / self.m.tp * 4 * 2
                   * (2 if self.train else 1))

    def optimizer_and_grads(self):
        if not self.train:
            return
        cfg = self.cfg
        p_total = cfg.param_count(active_only=False)
        p_loc = p_total / self.m.tp        # weights TP-sharded (approx.)
        # AdamW: read p,m,v, write p,m,v (fp32 moments) + grad read
        self.c.add("opt/adamw", flops=12.0 * p_loc,
                   bytes_=p_loc * (4 * 6 + self.wdt * 2))
        # gradient sync over dp (int8 compression: dist/compression.py —
        # per-block scales + error feedback; payload 1 byte/grad)
        gbytes = 1 if self.grad_compress == "int8" else 4
        if self.zero1:
            wire = _ring(p_loc * gbytes, self.m.dp, "rs") + \
                _ring(p_loc * self.wdt, self.m.dp, "ag")
        else:
            wire = _ring(p_loc * gbytes, self.m.dp, "ar")
        self.c.add("opt/gradsync", grad_wire=wire)

    # ------------------------------------------------------------------ #

    def build(self) -> Costs:
        cfg = self.cfg
        sh = self.shape
        decode = sh.kind == "decode"
        t = self.t_loc

        if cfg.encdec:
            if decode:
                # decoder only: self-attn over the cache + static cross-attn;
                # the encoder does NOT run per decode step
                for _ in range(cfg.n_layers):
                    self.attention_decode_layer(sh.seq_len)   # self
                    self.attention_decode_layer(sh.seq_len)   # cross (static)
                    self.mlp_layer(t)
                self.embed_logits(t, True)
            else:
                # encoder over S frames + teacher-forced decoder over S tokens
                for _ in range(cfg.n_layers):
                    self.attention_layer(sh.seq_len, sh.seq_len, causal=False)
                    self.mlp_layer(t)
                for _ in range(cfg.n_layers):
                    self.attention_layer(sh.seq_len, sh.seq_len, causal=True)
                    self.attention_layer(sh.seq_len, sh.seq_len, causal=False)
                    self.mlp_layer(t)
                self.embed_logits(t, True)
            self.optimizer_and_grads()
            return self.c

        for i in range(cfg.n_layers):
            kind = cfg.layer_kind(i)
            moe_here = cfg.moe is not None and (
                i % cfg.moe.every_k_layers == (cfg.moe.every_k_layers - 1)
                if cfg.moe.every_k_layers > 1 else True)
            if kind == "attn":
                if decode:
                    self.attention_decode_layer(sh.seq_len)
                else:
                    self.attention_layer(sh.seq_len, sh.seq_len, causal=True)
            elif kind == "mamba":
                self.mamba_layer(t, decode)
            elif kind in ("ssm", "rwkv6"):
                self.rwkv_layer(t, decode)
            if kind in ("attn", "mamba"):   # rwkv embeds its own channel-mix
                if moe_here:
                    self.moe_layer(t)
                else:
                    self.mlp_layer(t)
        self.embed_logits(t, cfg.tie_embeddings)
        self.optimizer_and_grads()
        return self.c


def analytic_report(cfg: ArchConfig, shape: ShapeSpec, dp: int, tp: int,
                    **knobs) -> Dict[str, float]:
    mesh = MeshModel(dp=dp, tp=tp)
    cm = CellModel(cfg, shape, mesh, **knobs)
    c = cm.build()
    t_comp = c.flops / hw.PEAK_FLOPS_BF16
    t_mem = c.bytes / hw.HBM_BW
    t_grad = c.grad_wire / hw.ICI_LINK_BW
    if cm.overlap_gradsync:
        # grad all-reduce overlapped with backward compute (bucketed async);
        # only the portion exceeding compute time is exposed
        t_coll = c.wire / hw.ICI_LINK_BW + max(0.0, t_grad - t_comp)
    else:
        t_coll = (c.wire + c.grad_wire) / hw.ICI_LINK_BW
    mf = cfg.model_flops(shape)
    t_bound = max(t_comp, t_mem, t_coll)
    return {
        "flops_per_device": c.flops,
        "bytes_per_device": c.bytes,
        "wire_bytes_per_device": c.wire + c.grad_wire,
        "grad_wire_bytes_per_device": c.grad_wire,
        "t_compute": t_comp,
        "t_memory": t_mem,
        "t_collective": t_coll,
        "bottleneck": max(
            {"compute": t_comp, "memory": t_mem, "collective": t_coll},
            key=lambda k: {"compute": t_comp, "memory": t_mem,
                           "collective": t_coll}[k]),
        "model_flops_total": mf,
        "useful_flops_ratio": mf / (c.flops * mesh.chips) if c.flops else 0.0,
        "roofline_fraction": (mf / (mesh.chips * hw.PEAK_FLOPS_BF16)) / t_bound
        if t_bound else 0.0,
        "top_flop_sites": dict(sorted(c.notes.items(),
                                      key=lambda kv: -kv[1])[:8]),
        "top_byte_sites": dict(sorted(c.byte_notes.items(),
                                      key=lambda kv: -kv[1])[:8]),
    }
