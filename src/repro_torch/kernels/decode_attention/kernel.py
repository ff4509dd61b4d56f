"""Launcher of the hand-written CUDA decode-attention kernel
(``csrc/decode_attention.cu``).

``launches`` counts the kernel's launches, so that a run can show that its
path went through the kernel.  The library is built and loaded at the
first call, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

launches = 0
MAX_GROUP = 8                          # MAXG in the CUDA source

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _entry():
    fn = _build.load("decode_attention").decode_forward
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, ctypes.c_float, _P]
    fn.restype = _I
    return fn


def _mask_arg(name: str, value: int | None) -> int:
    if value is None:
        return 0
    if value <= 0:
        raise ValueError(f"{name} must be positive or None, got {value}")
    return int(value)


def decode_attention_cuda(q, cache_k, cache_v, valid, *, pos=None,
                          window=None, chunk=None, rolling=False):
    """q: [B, H, D]; cache_k/v: [B, S, KVH, D], contiguous CUDA tensors of
    one dtype (bf16 or fp32), D in {16, 32, 64, 128}, H / KVH <= 8;
    valid/pos: [B] integer tensors.  ``pos=None`` means ``valid - 1``, with
    the window and chunk masks still applied.  Returns [B, H, D]."""
    global launches
    dev = q.device
    if not (q.is_cuda and cache_k.device == dev and cache_v.device == dev):
        raise ValueError("decode_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {cache_k.dtype}, "
                         f"{cache_v.dtype}: need one of bf16, fp32")
    if q.dim() != 3 or cache_k.dim() != 4 or cache_k.shape != cache_v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(cache_k.shape)}, "
                         f"{tuple(cache_v.shape)}")
    b, h, d = q.shape
    _, s, kvh, dk = cache_k.shape
    if (cache_k.shape[0] != b or dk != d or h % kvh
            or h // kvh > MAX_GROUP or d not in (16, 32, 64, 128)):
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(cache_k.shape)}")
    if not (q.is_contiguous() and cache_k.is_contiguous()
            and cache_v.is_contiguous()):
        raise ValueError("decode_attention_cuda takes contiguous tensors")
    if valid.shape != (b,) or (pos is not None and pos.shape != (b,)):
        raise ValueError(f"valid/pos must have shape ({b},)")
    window = _mask_arg("window", window)
    chunk = _mask_arg("chunk", chunk)
    if pos is None:
        pos = valid - 1
    valid = valid.to(device=dev, dtype=torch.int32).contiguous()
    pos = pos.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                       valid.data_ptr(), pos.data_ptr(), out.data_ptr(), b, s,
                       kvh, h // kvh, d, int(q.dtype == torch.bfloat16),
                       window, chunk, int(rolling), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
