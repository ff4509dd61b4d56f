"""Shared model building blocks: norms, RoPE (incl. partial), embeddings
and SwiGLU MLPs.  Pure functions over nested dicts of tensors.

As in the JAX package, parameters are kept in fp32 and cast to the
compute dtype (bf16) at use; the large products are plain ``torch.matmul``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import spec

COMPUTE_DTYPE = torch.bfloat16


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * weight.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, rope_pct: float, theta: float, device=None):
    rot_dim = int(head_dim * rope_pct) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    inv = 1.0 / (theta ** exps)
    return inv, rot_dim


def apply_rope(x, positions, *, theta: float, rope_pct: float = 1.0,
               mrope_sections: tuple[int, ...] = ()):
    """x: [B, S, H, D].  positions: [B, S].  The rotation covers the first
    ``rope_pct`` of each head; the rest passes through (partial RoPE)."""
    if mrope_sections:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")
    d = x.shape[-1]
    inv, rot_dim = rope_freqs(d, rope_pct, theta, device=x.device)
    half = rot_dim // 2
    angles = positions.float()[..., None] * inv[None, None, :]  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]                      # [B, S, 1, half]
    sin = torch.sin(angles)[:, :, None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    xr = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([xr.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, layers: int, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    L = (layers,)
    return {
        "gate": spec(L + (d, f), ("layers", "embed", "ffn")),
        "up": spec(L + (d, f), ("layers", "embed", "ffn")),
        "down": spec(L + (f, d), ("layers", "ffn", "embed")),
    }


def swiglu(p, x):
    """p holds per-layer slices (no leading L dim at call time)."""
    h = F.silu(x @ p["gate"].to(x.dtype)) * (x @ p["up"].to(x.dtype))
    return h @ p["down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig):
    out = {"embedding": spec((cfg.vocab_size, cfg.d_model),
                             ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        out["lm_head"] = spec((cfg.d_model, cfg.vocab_size),
                              ("embed", "vocab"))
    return out


def embed(params, tokens, cfg: ModelConfig):
    # gather, then cast: the same values as casting the whole table first
    x = params["embedding"][tokens].to(COMPUTE_DTYPE)
    return x * cfg.embed_scale


def unembed(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        w = params["embedding"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    return (x @ w) * cfg.logit_scale
