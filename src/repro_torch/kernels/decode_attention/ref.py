"""Plain oracle for single-token decode attention against a KV cache."""

from __future__ import annotations

import torch


def decode_reference(q, cache_k, cache_v, valid, *, pos=None, window=None,
                     chunk=None, rolling=False, scale=None):
    """q: [B, H, D]; cache_k/v: [B, S, KVH, D]; valid: [B] (# live slots);
    pos: [B] absolute position of the current token (needed for window /
    chunk masks on non-rolling caches).  Returns [B, H, D].

    As in the JAX package's oracle, ``pos=None`` skips the window and chunk
    masks; the kernel instead takes ``pos = valid - 1`` and keeps them.
    """
    b, h, d = q.shape
    _, s, kvh, _ = cache_k.shape
    group = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = cache_k.float().repeat_interleave(group, dim=2)
    vf = cache_v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", qf, kf)
    k_pos = torch.arange(s, device=q.device)[None, :]            # [1, S]
    mask = k_pos < valid[:, None]
    if not rolling and pos is not None:
        if window is not None:
            mask &= k_pos > (pos[:, None] - window)
        if chunk is not None:
            mask &= torch.div(k_pos, chunk, rounding_mode="floor") == \
                torch.div(pos[:, None], chunk, rounding_mode="floor")
    logits = logits.masked_fill(~mask[:, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhs,bshd->bhd", p, vf).to(q.dtype)
