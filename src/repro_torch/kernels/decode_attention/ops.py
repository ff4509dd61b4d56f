"""Dispatching wrapper for decode attention.

- ``decode_attention_torch``: the plain version, ``ref.decode_reference``
  with the kernel's reading of ``pos=None`` (``pos = valid - 1``, window
  and chunk masks kept).  A CPU tensor takes it;
- ``kernel.decode_attention_cuda``: the hand-written CUDA kernel, which a
  CUDA tensor takes.
"""

from __future__ import annotations

from . import kernel, ref


def decode_attention_torch(q, cache_k, cache_v, valid, *, pos=None,
                           window=None, chunk=None, rolling=False):
    if pos is None:
        pos = valid - 1
    return ref.decode_reference(q, cache_k, cache_v, valid, pos=pos,
                                window=window, chunk=chunk, rolling=rolling)


def decode_attention(q, cache_k, cache_v, valid, *, pos=None, window=None,
                     chunk=None, rolling=False):
    """q: [B, H, D]; cache_k/v: [B, S, KVH, D]; valid/pos: [B] int.  The
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if q.device.type == "cpu":
        return decode_attention_torch(q, cache_k, cache_v, valid, pos=pos,
                                      window=window, chunk=chunk,
                                      rolling=rolling)
    return kernel.decode_attention_cuda(q, cache_k, cache_v, valid, pos=pos,
                                        window=window, chunk=chunk,
                                        rolling=rolling)
