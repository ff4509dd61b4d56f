"""Dispatching wrapper for flash attention.

Two implementations with identical semantics:

- ``flash_attention_torch``: streaming softmax over KV blocks in plain
  PyTorch, the port of the JAX package's ``flash_attention_jnp``.  It is
  the plain version the kernel is held against, and what a CPU tensor
  takes;
- ``kernel.flash_attention_cuda``: the hand-written CUDA kernel, which a
  CUDA tensor takes.

Both take q [B, Sq, H, D], k/v [B, Skv, KVH, D] and return q's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel

NEG_INF = -1e30


def flash_attention_torch(q, k, v, *, causal=True, window=None, chunk=None,
                          q_offset=0, block_k=512):
    """Online softmax over KV blocks, fp32 inside (flash semantics)."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    group = h // kvh
    scale = d ** -0.5
    block_k = min(block_k, skv)
    nk = -(-skv // block_k)
    pad = nk * block_k - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))

    qf = (q.float() * scale).transpose(1, 2)                     # [b,h,sq,d]
    kf = k.float().transpose(1, 2)                               # [b,kvh,S,d]
    vf = v.float().transpose(1, 2)
    q_pos = torch.arange(sq, device=q.device) + q_offset

    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for ki in range(nk):
        sl = slice(ki * block_k, (ki + 1) * block_k)
        kblk = kf[:, :, sl].repeat_interleave(group, dim=1)      # [b,h,bk,d]
        vblk = vf[:, :, sl].repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kblk)
        k_pos = ki * block_k + torch.arange(block_k, device=q.device)
        mask = (k_pos[None, :] < skv).expand(sq, block_k)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        if chunk is not None:
            mask = mask & (torch.div(k_pos[None, :], chunk, rounding_mode="floor")
                           == torch.div(q_pos[:, None], chunk,
                                        rounding_mode="floor"))
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vblk)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=None, chunk=None,
                    q_offset=0):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     chunk=chunk, q_offset=q_offset)
    return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       chunk=chunk, q_offset=q_offset)
