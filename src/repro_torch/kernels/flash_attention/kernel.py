"""Launcher of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

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

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _entry():
    fn = _build.load("flash_attention").fa_forward
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, ctypes.c_float, _P]
    fn.restype = _I
    return fn


def _mask_arg(name: str, value: int | None) -> int:
    if value is None:
        return 0
    if value <= 0:
        raise ValueError(f"{name} must be positive or None, got {value}")
    return int(value)


def flash_attention_cuda(q, k, v, *, causal=True, window=None, chunk=None,
                         q_offset=0):
    """q: [B, Sq, H, D]; k/v: [B, Skv, KVH, D], contiguous CUDA tensors of
    one dtype (bf16 or fp32), D in {16, 32, 64, 128}, H % KVH == 0.
    Returns [B, Sq, H, D] in q's dtype."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda takes CUDA tensors on one device")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                         "need one of bf16, fp32")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, skv, kvh, dk = k.shape
    if k.shape[0] != b or dk != d or h % kvh or d not in (16, 32, 64, 128):
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda takes contiguous tensors")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    window = _mask_arg("window", window)
    chunk = _mask_arg("chunk", chunk)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, sq, skv, h, kvh, d,
                       int(q.dtype == torch.bfloat16), int(causal), window,
                       chunk, int(q_offset), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
