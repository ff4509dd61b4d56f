"""Plain O(S^2) oracle for flash attention (GQA + causal + sliding-window +
chunked-local masks).  Correctness reference only."""

from __future__ import annotations

import torch


def attention_mask(q_len: int, kv_len: int, *, causal: bool = True,
                   window: int | None = None, chunk: int | None = None,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """[q_len, kv_len] boolean mask; True = attend.

    ``q_offset`` is the absolute position of q[0] (prefill continuation).
    ``window``: attend only to the last `window` positions (inclusive of
    self).  ``chunk``: block-diagonal local attention (llama4-style): a
    query attends only within its own chunk of size `chunk`.
    """
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if chunk is not None:
        mask &= torch.div(k_pos, chunk, rounding_mode="floor") == \
            torch.div(q_pos, chunk, rounding_mode="floor")
    return mask


def mha_reference(q, k, v, *, causal=True, window=None, chunk=None,
                  q_offset=0, scale=None):
    """q: [B, Sq, H, D]; k/v: [B, Skv, KVH, D] with H % KVH == 0.

    Returns [B, Sq, H, D] in q's dtype; softmax in fp32.  Rows with no
    live key give 0.
    """
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    group = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = attention_mask(sq, skv, causal=causal, window=window, chunk=chunk,
                          q_offset=q_offset, device=q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)
