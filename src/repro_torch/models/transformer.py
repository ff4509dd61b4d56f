"""Decoder-only dense transformer (qwen2-0.5b, minicpm-2b, h2o-danube,
stablelm-12b).

Parameters keep the JAX package's stacked layout (a leading L dim on every
block leaf); the JAX package's layer ``lax.scan`` is a Python loop over
that dim here.
"""

from __future__ import annotations

import torch

from .attention import (attention_specs, cache_shape, decode_attention,
                        layer_mask_kind, self_attention)
from .config import ModelConfig
from .layers import (COMPUTE_DTYPE, embed, embed_specs, mlp_specs, rms_norm,
                     swiglu, unembed)
from .params import spec


def transformer_specs(cfg: ModelConfig):
    L = cfg.num_layers
    blocks = {
        "ln1": spec((L, cfg.d_model), ("layers", "embed"), init="ones"),
        "ln2": spec((L, cfg.d_model), ("layers", "embed"), init="ones"),
        "attn": attention_specs(cfg, L),
        "mlp": mlp_specs(cfg, L),
    }
    return {
        **embed_specs(cfg),
        "blocks": blocks,
        "final_norm": spec((cfg.d_model,), ("embed",), init="ones"),
    }


def _layer_params(p, idx: int):
    """Slice one layer's parameters out of the stacked tree (views)."""
    if isinstance(p, dict):
        return {k: _layer_params(v, idx) for k, v in p.items()}
    return p[idx]


def _block(p, x, cfg: ModelConfig, positions, layer_idx: int):
    """One transformer block (pre-norm)."""
    mk = layer_mask_kind(cfg, layer_idx)
    h = rms_norm(x, p["ln1"].float(), cfg.norm_eps)
    h = self_attention(p["attn"], h, cfg, positions, **mk)
    x = x + h * cfg.residual_scale
    h = rms_norm(x, p["ln2"].float(), cfg.norm_eps)
    h = swiglu(p["mlp"], h)
    return x + h * cfg.residual_scale


def forward(params, batch: dict, cfg: ModelConfig, *, last_only=False):
    """Prefill forward -> (logits [B, S, V], aux_loss).

    ``last_only`` slices the final position BEFORE the unembedding matmul
    (serving prefill needs one next-token distribution, not B x S x V)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed(params, tokens, cfg)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None, :].expand(b, s)
    for i in range(cfg.num_layers):
        x = _block(_layer_params(params["blocks"], i), x, cfg, positions, i)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"].float(), cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return unembed(params, x, cfg), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache_specs(cfg: ModelConfig, batch: int, s_max: int):
    shape, axes = cache_shape(cfg, batch, s_max)
    return {"k": spec(shape, axes, init="zeros", dtype=COMPUTE_DTYPE),
            "v": spec(shape, axes, init="zeros", dtype=COMPUTE_DTYPE)}


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """tokens: [B, 1]; pos: [B] -> (logits [B, V], cache).  The cache is
    updated in place and returned."""
    x = embed(params, tokens, cfg)
    for i in range(cfg.num_layers):
        p = _layer_params(params["blocks"], i)
        h = rms_norm(x, p["ln1"].float(), cfg.norm_eps)
        h, _, _ = decode_attention(p["attn"], h, cfg, cache["k"][i],
                                   cache["v"][i], pos,
                                   **layer_mask_kind(cfg, i))
        x = x + h * cfg.residual_scale
        h = rms_norm(x, p["ln2"].float(), cfg.norm_eps)
        x = x + swiglu(p["mlp"], h) * cfg.residual_scale
    x = rms_norm(x, params["final_norm"].float(), cfg.norm_eps)
    logits = unembed(params, x, cfg)
    return logits[:, 0], cache
