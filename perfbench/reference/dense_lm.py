"""Plain reference of the decoder-only dense transformer of the Llama
architecture (SmolLM2 as published), with the shapes and work of one
training step.

The weights are the program's leaves by path (``groups/0/attn/wq`` is
(L, d, H·dh), stacked over layers); the reference reads them and nothing
else of the program.  Per layer: a pre-RMSNorm causal self-attention with
grouped KV heads and rotary positions (no biases), then a pre-RMSNorm
gated MLP, SiLU(x·W_gate) ⊙ (x·W_up) · W_down, each added to the residual
stream.  A final RMSNorm, then logits against the embedding where the
configuration ties them (else ``lm_head``).  The loss is the mean cross
entropy over every token of the batch.
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch

from perfbench.reference.common import (ACTS, Precision, attention,
                                        cross_entropy_sum, gated_mlp, leaf,
                                        rmsnorm, rope)


def dims(cfg: Dict) -> Dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "L": cfg["num_hidden_layers"], "H": h,
            "KV": cfg["num_key_value_heads"], "dh": d // h,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "eps": cfg["rms_norm_eps"], "act": cfg["hidden_act"],
            "theta": cfg["rope_theta"], "tied": cfg["tie_word_embeddings"]}


def batch_shapes(cfg: Dict, job: Dict) -> Dict:
    b, t = job["batch"], job["tokens"]
    return {"tokens": ((b, t), "tokens"), "labels": ((b, t), "labels")}


def loss_tokens(cfg: Dict, job: Dict) -> int:
    return job["batch"] * job["tokens"]


def attention_launches(cfg: Dict, job: Dict) -> list:
    m = dims(cfg)
    return [(job["batch"], job["tokens"], job["tokens"], m["H"], m["KV"],
             m["dh"], True)] * m["L"]


def model_flops(cfg: Dict, job: Dict) -> float:
    """Model FLOPs of one training step: projections, causal attention,
    the MLP and the logits; times 3 for the backward.  Without remat's
    recompute."""
    m = dims(cfg)
    d, h, kv, dh = m["d"], m["H"], m["KV"], m["dh"]
    b, s = job["batch"], job["tokens"]
    t = b * s
    layer = 2 * t * (2 * d * h * dh + 2 * d * kv * dh)
    layer += 4 * dh * h * b * s * (s + 1) // 2
    layer += 2 * t * 3 * d * m["F"]
    return 3.0 * (m["L"] * layer + 2 * t * d * m["V"])


def loss_sum(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
             labels: torch.Tensor, cfg: Dict, pr: Precision) -> torch.Tensor:
    """The summed cross entropy of a block of rows."""
    m = dims(cfg)
    eps, act = m["eps"], ACTS[m["act"]]
    b, s = tokens.shape
    h = pr.q(params["embed"][tokens.long()])
    for i in range(m["L"]):
        x = rmsnorm(h, leaf(params, "groups/0/ln1/scale", i), eps)
        q = rope(pr.mm(x, leaf(params, "groups/0/attn/wq", i)).reshape(
            b, s, m["H"], m["dh"]), m["theta"])
        k = rope(pr.mm(x, leaf(params, "groups/0/attn/wk", i)).reshape(
            b, s, m["KV"], m["dh"]), m["theta"])
        v = pr.mm(x, leaf(params, "groups/0/attn/wv", i)).reshape(
            b, s, m["KV"], m["dh"])
        o = attention(q, k, v, True, pr).reshape(b, s, m["H"] * m["dh"])
        h = pr.q(h + pr.mm(o, leaf(params, "groups/0/attn/wo", i)))
        x = rmsnorm(h, leaf(params, "groups/0/ln2/scale", i), eps)
        h = pr.q(h + gated_mlp(x, leaf(params, "groups/0/mlp/w_gate", i),
                               leaf(params, "groups/0/mlp/w_up", i),
                               leaf(params, "groups/0/mlp/w_down", i), act,
                               pr))
    head = params["embed"].T if m["tied"] else params["lm_head"]
    logits = pr.mm(rmsnorm(h, params["ln_f/scale"], eps), head)
    return cross_entropy_sum(logits, labels)


def forward_blocks(params: Dict[str, torch.Tensor], batch: Dict, cfg: Dict,
                   job: Dict, pr: Precision) -> Iterator[torch.Tensor]:
    """Each block of ``job["reference_rows"]`` rows' share of the step's
    loss, with autograd."""
    tokens, labels = batch["tokens"], batch["labels"]
    n = labels.numel()
    rows = job["reference_rows"]
    for r in range(0, tokens.shape[0], rows):
        sl = slice(r, r + rows)
        yield loss_sum(params, tokens[sl], labels[sl], cfg, pr) / n
