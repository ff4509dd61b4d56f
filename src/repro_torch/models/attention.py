"""GQA attention for the transformer family: full / sliding-window /
chunked-local masks, QKV bias, per-head qk-norm and partial RoPE; prefill
and single-token decode against a KV cache.  Single device: the JAX
package's mesh branches have no counterpart here."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from .config import ModelConfig
from .layers import apply_rope, rms_norm
from .params import spec


def attention_specs(cfg: ModelConfig, layers: int):
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    L = (layers,)
    out = {
        "wq": spec(L + (d, q), ("layers", "embed", "heads")),
        "wk": spec(L + (d, kv), ("layers", "embed", "kv_heads")),
        "wv": spec(L + (d, kv), ("layers", "embed", "kv_heads")),
        "wo": spec(L + (q, d), ("layers", "heads", "embed")),
    }
    if cfg.qkv_bias:
        out |= {
            "bq": spec(L + (q,), ("layers", "heads"), init="zeros"),
            "bk": spec(L + (kv,), ("layers", "kv_heads"), init="zeros"),
            "bv": spec(L + (kv,), ("layers", "kv_heads"), init="zeros"),
        }
    if cfg.qk_norm:
        out |= {
            "q_norm": spec(L + (cfg.head_dim,), ("layers", None), init="ones"),
            "k_norm": spec(L + (cfg.head_dim,), ("layers", None), init="ones"),
        }
    return out


def _project_qkv(p, x, cfg: ModelConfig, positions, *, rope: bool):
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"].float(), cfg.norm_eps)
        k = rms_norm(k, p["k_norm"].float(), cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       rope_pct=cfg.rope_pct,
                       mrope_sections=cfg.mrope_sections)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       rope_pct=cfg.rope_pct,
                       mrope_sections=cfg.mrope_sections)
    return q, k, v


def layer_mask_kind(cfg: ModelConfig, layer_idx) -> dict:
    """Per-layer mask parameters (llama4: every `global_every`-th layer is
    global full attention with NoPE; others chunked-local with RoPE)."""
    if cfg.chunk_size and cfg.global_every:
        is_global = (layer_idx + 1) % cfg.global_every == 0
        return dict(window=None,
                    chunk=None if is_global else cfg.chunk_size,
                    rope=not is_global)
    return dict(window=cfg.sliding_window, chunk=cfg.chunk_size, rope=True)


def self_attention(p, x, cfg: ModelConfig, positions, *, causal=True,
                   window=None, chunk=None, rope=True):
    """Training / prefill attention.  x: [B, S, D]."""
    q, k, v = _project_qkv(p, x, cfg, positions, rope=rope)
    b, s = x.shape[:2]
    out = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, window=window, chunk=chunk)
    out = out.reshape(b, s, cfg.q_dim)
    return out @ p["wo"].to(x.dtype)


def decode_attention(p, x, cfg: ModelConfig, cache_k, cache_v, pos, *,
                     window=None, chunk=None, rope=True):
    """Single-token decode.  x: [B, 1, D]; cache_[kv]: [B, S_max, KVH, Dh];
    pos: [B] number of tokens already in the cache.

    Writes this token's K and V into ``cache_k`` / ``cache_v`` IN PLACE, at
    slot ``pos % S_max`` for a rolling cache (window >= S_max) and ``pos``
    otherwise, and returns (out [B, 1, D], cache_k, cache_v) with the same
    two cache tensors."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None], rope=rope)
    s_max = cache_k.shape[1]
    rolling = window is not None and s_max <= window
    slot = pos % s_max if rolling else pos
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    valid = torch.clamp(pos + 1, max=s_max)
    out = da.decode_attention(q[:, 0].contiguous(), cache_k, cache_v, valid,
                              pos=pos, window=window, chunk=chunk,
                              rolling=rolling)
    out = out.reshape(b, 1, cfg.q_dim)
    return out @ p["wo"].to(x.dtype), cache_k, cache_v


def cache_shape(cfg: ModelConfig, batch: int, s_max: int):
    """KV cache shape and logical axes for one layer stack."""
    if cfg.sliding_window is not None:
        s_max = min(s_max, cfg.sliding_window)
    shape = (cfg.num_layers, batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    axes = ("layers", "cache_batch", "cache_seq", None, None)
    return shape, axes
