"""Step builders for serving: prefill and decode on one device.

Each builder returns ``(step_fn, None)``, the JAX package's tuple at
``mesh=None``; the second slot held its shardings.  The steps run under
``torch.inference_mode()``.
"""

from __future__ import annotations

import torch

from repro_torch.models.api import Model


def build_prefill_step(model: Model):
    """prefill(params, batch) -> next-token logits [B, V] in fp32."""

    @torch.inference_mode()
    def prefill(params, batch):
        # the hidden state is sliced to the final position BEFORE the
        # unembedding matmul: one next-token distribution per request,
        # not a [B, S, V] logits tensor
        logits, _ = model.forward(params, batch, last_only=True)
        return logits[:, -1].float()

    return prefill, None


def build_decode_step(model: Model):
    """decode(params, cache, tokens [B, 1], pos [B]) ->
    (next_tok [B] int32, logits [B, V] fp32, cache).  The cache is updated
    in place."""

    @torch.inference_mode()
    def decode(params, cache, tokens, pos):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits.float(), cache

    return decode, None
