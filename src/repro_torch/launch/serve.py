"""Serving launcher: batched prefill, then greedy decode against a KV
cache, on one device.

``python -m repro_torch.launch.serve --full --requests 8``

Runs on ``cuda`` unless ``--device cpu`` is given; asking for CUDA where
there is none raises.  Weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.api import build_model
from repro_torch.models.params import init_params
from repro_torch.runtime.steps import build_decode_step, build_prefill_step


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for and is not available; "
                           "pass --device cpu to run on the CPU")
    return dev


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model, params, tokens, *, gen_len: int, cache_len: int):
    """Prefill ``tokens`` [B, S], then ``gen_len`` greedy decode steps.
    Returns (ids [B, gen_len + 1], prefill logits [B, V], the last decode
    step's logits [B, V], prefill seconds, decode seconds)."""
    dev = tokens.device
    b, s = tokens.shape
    if s + gen_len > cache_len and model.cfg.sliding_window is None:
        raise ValueError(f"prompt {s} + {gen_len} new tokens do not fit a "
                         f"cache of {cache_len}")
    prefill, _ = build_prefill_step(model)
    decode, _ = build_decode_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    last_logits = prefill(params, {"tokens": tokens})
    next_tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    cache = init_params(model.cache_specs(b, cache_len), None, dev)
    pos = torch.full((b,), s, dtype=torch.int64, device=dev)
    toks = [next_tok]
    logits = last_logits
    t0 = time.perf_counter()
    for i in range(gen_len):
        next_tok, logits, cache = decode(params, cache, next_tok[:, None],
                                         pos + i)
        toks.append(next_tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    ids = torch.stack(toks, dim=1)
    return ids, last_logits, logits, t_prefill, t_decode


def serve(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = init_params(model.specs(),
                         torch.Generator(dev).manual_seed(args.seed), dev)
    b = args.requests
    batch = model.make_batch(torch.Generator(dev).manual_seed(args.seed + 1),
                             batch=b, seq=args.prompt_len)

    ids, _, _, t_prefill, t_decode = generate(
        model, params, batch["tokens"], gen_len=args.gen_len,
        cache_len=args.cache_len)
    print(f"prefill: {b} x {args.prompt_len} tokens in {t_prefill:.3f}s")
    print(f"decode: {args.gen_len} steps x {b} requests in {t_decode:.3f}s "
          f"({b * args.gen_len / t_decode:.1f} tok/s)")
    gen = ids.cpu().numpy()
    print("generated ids (first request):", gen[0][:12], "...")
    return gen


if __name__ == "__main__":
    serve()
