#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds every CUDA kernel of the serving path from the sources in this
   checkout, one nvcc per source, in parallel;
3. holds the flash-attention kernel (prefill) against its plain PyTorch
   version on the card, at the serving shapes and over the mask cases;
4. does the same for the decode-attention kernel;
5. times each kernel, its plain version and one PyTorch library call that
   computes the same function (CUDA events, after warm-up);
6. serves full-width qwen2-0.5b through ``repro_torch.launch.serve`` with
   the launch counts zeroed just before and read just after, then checks
   the served path's logits against the plain versions on the same inputs;
7. prints the kernels line and, last, the device line.

Any failure raises and exits non-zero; without a CUDA device, or away from
the repository's ``src/``, it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}   # tests/test_kernels.py
SLEEP_CYCLES = 40_000_000            # ~20 ms at the H100's ~2 GHz SM clock

# the serving run: full-width qwen2-0.5b, 8 requests of 256 tokens, 32 new
SERVE_ARGS = ["--full", "--requests", "8", "--prompt-len", "256",
              "--gen-len", "32", "--cache-len", "512"]
B, S, GEN, S_MAX = 8, 256, 32, 512
H, KVH, D, LAYERS = 14, 2, 64, 24


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=5, batch=10) -> float:
    """Device time of one call: the median over ``reps`` batches of
    ``batch`` back-to-back calls timed with CUDA events.  Each batch waits
    behind a ~20 ms device sleep, so the host has queued the whole batch
    before the device starts on it and host overhead stays out."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check(name, got, want, dtype) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{name}: {m}")
    print(f"  {name}: max|err| {err:.3e} (tol {tol:g})")
    return err


def check_flash(fa, fa_kernel, gen):
    """K1 against flash_attention_torch on the card.  Returns the error at
    the serving shapes."""
    cases = [  # (label, b, sq, skv, h, kvh, d, dtype, mask kwargs)
        ("serving causal", B, S, S, H, KVH, D, torch.bfloat16, {}),
        ("non-causal", B, S, S, H, KVH, D, torch.bfloat16,
         dict(causal=False)),
        ("window 64", B, S, S, H, KVH, D, torch.bfloat16, dict(window=64)),
        ("chunk 96", B, S, S, H, KVH, D, torch.bfloat16, dict(chunk=96)),
        ("q_offset 256", B, 64, 320, H, KVH, D, torch.bfloat16,
         dict(q_offset=256)),
        ("Sq != Skv", B, 100, S, H, KVH, D, torch.bfloat16,
         dict(causal=False)),
        ("ragged S 200", B, 200, 200, H, KVH, D, torch.bfloat16, {}),
        ("fp32", B, S, S, H, KVH, D, torch.float32, {}),
        ("fp32 D128 window", 2, 130, 130, 8, 2, 128, torch.float32,
         dict(window=33)),
        ("D32 chunk", 2, 96, 96, 4, 4, 32, torch.bfloat16, dict(chunk=64)),
        ("D16 q_offset window", 2, 96, 160, 2, 1, 16, torch.float32,
         dict(q_offset=64, window=48)),
        ("dead rows", 1, 64, 64, 2, 1, 64, torch.float32,
         dict(window=8, q_offset=1000)),
        ("some rows dead in a live tile", 1, 64, 64, 2, 1, 64, torch.float32,
         dict(window=8, q_offset=50)),
    ]
    main_err = None
    for label, b, sq, skv, h, kvh, d, dtype, kw in cases:
        q = randn(gen, (b, sq, h, d), dtype)
        k = randn(gen, (b, skv, kvh, d), dtype)
        v = randn(gen, (b, skv, kvh, d), dtype)
        got = fa_kernel.flash_attention_cuda(q, k, v, **kw)
        err = check(f"flash {label}", got, fa.flash_attention_torch(
            q, k, v, **kw), dtype)
        if main_err is None:
            main_err = err
    return main_err


def check_decode(da, da_kernel, gen):
    """K2 against decode_attention_torch on the card.  Returns the error at
    the serving shapes."""
    valid = torch.tensor([1, 37, 100, 257, 273, 288, 511, 512], device="cuda")
    cases = [  # (label, b, s, h, kvh, d, dtype, valid, pos, mask kwargs)
        ("serving", B, S_MAX, H, KVH, D, torch.bfloat16, valid, valid - 1, {}),
        ("window 128", B, S_MAX, H, KVH, D, torch.bfloat16, valid, valid - 1,
         dict(window=128)),
        ("chunk 100", B, S_MAX, H, KVH, D, torch.bfloat16, valid, valid - 1,
         dict(chunk=100)),
        ("rolling", B, S_MAX, H, KVH, D, torch.bfloat16,
         torch.full((B,), S_MAX, device="cuda"),
         torch.arange(B, device="cuda") * 100 + 600,
         dict(window=S_MAX, rolling=True)),
        ("pos None window", B, S_MAX, H, KVH, D, torch.bfloat16, valid, None,
         dict(window=64)),
        ("fp32", B, S_MAX, H, KVH, D, torch.float32, valid, valid - 1, {}),
        ("D128 G8 fp32", 3, 200, 8, 1, 128, torch.float32,
         valid[:3] % 200 + 1, valid[:3] % 200, dict(window=50)),
        ("D32 G1", 3, 96, 4, 4, 32, torch.bfloat16,
         torch.tensor([1, 50, 96], device="cuda"), None, {}),
        ("D16 G2 chunk", 2, 64, 4, 2, 16, torch.float32,
         torch.tensor([64, 40], device="cuda"), None, dict(chunk=16)),
    ]
    main_err = None
    for label, b, s, h, kvh, d, dtype, vl, pos, kw in cases:
        q = randn(gen, (b, h, d), dtype)
        ck = randn(gen, (b, s, kvh, d), dtype)
        cv = randn(gen, (b, s, kvh, d), dtype)
        got = da_kernel.decode_attention_cuda(q, ck, cv, vl, pos=pos, **kw)
        err = check(f"decode {label}", got, da.decode_attention_torch(
            q, ck, cv, vl, pos=pos, **kw), dtype)
        if main_err is None:
            main_err = err
    return main_err


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def measure_flash(fa, fa_ref, fa_kernel, gen):
    """K1 at the serving prefill's shapes: q [8,256,14,64], k/v
    [8,256,2,64], bf16, causal.  Inputs stay L2-resident across launches,
    as the projections that produce them leave them."""
    import torch.nn.functional as F
    dt = torch.bfloat16
    q = randn(gen, (B, S, H, D), dt)
    k = randn(gen, (B, S, KVH, D), dt)
    v = randn(gen, (B, S, KVH, D), dt)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = time_ms(lambda: fa_kernel.flash_attention_cuda(q, k, v))
    plain = time_ms(lambda: fa.flash_attention_torch(q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    live = int(fa_ref.attention_mask(S, S, device="cuda").sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * D * B * H * live
    return ms, plain, lib, bound_ms(nbytes, flops, dt)


def measure_decode(da, da_kernel, gen):
    """K2 at the last serving decode step's shapes: q [8,14,64], cache
    [8,512,2,64] bf16, valid 288 in every row."""
    import torch.nn.functional as F
    dt = torch.bfloat16
    q = randn(gen, (B, H, D), dt)
    ck = randn(gen, (B, S_MAX, KVH, D), dt)
    cv = randn(gen, (B, S_MAX, KVH, D), dt)
    valid = torch.full((B,), S + GEN, dtype=torch.int32, device="cuda")
    pos = valid - 1
    qt = q[:, :, None]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (ck, cv))
    mask = (torch.arange(S_MAX, device="cuda")[None, :]
            < valid[:, None])[:, None, None, :]
    ms = time_ms(lambda: da_kernel.decode_attention_cuda(q, ck, cv, valid,
                                                         pos=pos))
    plain = time_ms(lambda: da.decode_attention_torch(q, ck, cv, valid,
                                                      pos=pos))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    live = int(valid.sum())
    nbytes = ((2 * q.numel() + 2 * live * KVH * D) * q.element_size()
              + 2 * B * 4)
    flops = 4 * D * H * live
    return ms, plain, lib, bound_ms(nbytes, flops, dt)


@contextmanager
def plain_attention(fa, da):
    """Route the model's attention to the plain versions, on the card."""
    saved = fa.flash_attention, da.decode_attention
    fa.flash_attention = fa.flash_attention_torch
    da.decode_attention = da.decode_attention_torch
    try:
        yield
    finally:
        fa.flash_attention, da.decode_attention = saved


def run_path(model, params, tokens, forced=None):
    """Prefill, then 4 greedy decode steps; ``forced`` replays another run's
    tokens so that two runs decode the same inputs."""
    from repro_torch.models.params import init_params
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step
    prefill = build_prefill_step(model)[0]
    decode = build_decode_step(model)[0]
    logits = [prefill(params, {"tokens": tokens})]
    toks = [logits[0].argmax(-1)]
    cache = init_params(model.cache_specs(B, S_MAX), None, "cuda")
    pos = torch.full((B,), S, dtype=torch.int64, device="cuda")
    for i in range(4):
        tok = toks[i] if forced is None else forced[i]
        _, lg, cache = decode(params, cache, tok[:, None].long(),
                              pos + i)
        logits.append(lg)
        toks.append(lg.argmax(-1))
    return logits, toks


@contextmanager
def fp32_compute():
    """Run the model in fp32 throughout (activations, cache, attention):
    the reference that both bf16 paths are measured against."""
    from repro_torch.models import layers, transformer
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = transformer.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = transformer.COMPUTE_DTYPE = saved


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def check_model(k_logits, p_logits, r_logits):
    """Logits of the kernel path against the plain path and fp32.

    A flat 2e-2 per logit does not hold across 24 layers: the two bf16
    paths round the attention output differently in a few elements, and
    the stack amplifies those single bf16 steps (max |kernel - plain| up
    to 0.08 on logits of std ~0.6, H100 run).  So the bf16 tolerance bounds
    the norm-wise relative difference, and the kernel path may be no
    farther from the fp32 reference than 1.5x the plain path is."""
    for i, (kl, pl, rl) in enumerate(zip(k_logits, p_logits, r_logits)):
        step = "prefill" if i == 0 else f"decode step {i}"
        if not torch.isfinite(kl).all():
            raise RuntimeError(f"non-finite logits at {step}")
        e_kp, e_k, e_p = rel_err(kl, pl), rel_err(kl, rl), rel_err(pl, rl)
        amax = (kl - pl).abs().max().item()
        print(f"  model {step} logits: |kernel-plain|/|plain| {e_kp:.3e} "
              f"(max abs {amax:.3e}); vs fp32: kernel {e_k:.3e}, "
              f"plain {e_p:.3e}")
        if e_kp > TOL[torch.bfloat16] or e_k > 1.5 * e_p:
            raise RuntimeError(f"model {step}: kernel path off the reference")


def device_profile(fn, n):
    """Run ``fn`` n times under torch.profiler; returns the device kernels'
    busy ms per run and the kernels sorted by their time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    return busy, kernels


def profile_serving(model, params, tokens, steps=8):
    """Steady-state prefill and decode-step times at the served shapes
    (host clock, synchronised), the device's busy time in each, and the
    kernels that take it (torch.profiler)."""
    import time
    from repro_torch.models.params import init_params
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step
    prefill = build_prefill_step(model)[0]
    decode = build_decode_step(model)[0]
    cache = init_params(model.cache_specs(B, S_MAX), None, "cuda")
    tok = torch.zeros((B, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((B,), S, dtype=torch.int64, device="cuda")

    def timed(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(out)

    for name, fn, n in (
            (f"prefill ({B} x {S} tokens)",
             lambda: prefill(params, {"tokens": tokens}), 5),
            (f"decode step ({B} tokens at position {S})",
             lambda: decode(params, cache, tok, pos), steps)):
        host = timed(fn, n)
        busy, kernels = device_profile(fn, n)
        print(f"steady {name}: {host:.3f} ms host clock, {busy:.3f} ms "
              f"device busy ({100 * busy / host:.1f} %)")
        for e in kernels[:8]:
            print(f"  {e.self_device_time_total / 1e3 / n:.4f} ms, "
                  f"{e.count // n} launches: {e.key[:72]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch.serve import serve
    from repro_torch.models.api import build_model
    from repro_torch.models.params import init_params

    # the plain versions are the reference: full fp32 products on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card -----------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # -- 2. build ----------------------------------------------------------
    secs = _build.build()
    print(f"build: {', '.join(_build.NAMES)} in {secs:.1f}s "
          f"(nvcc, parallel)")
    for name in _build.NAMES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    # -- 3, 4. kernels against their plain versions ------------------------
    fa_err = check_flash(fa, fa_kernel, gen)
    da_err = check_decode(da, da_kernel, gen)

    # -- 5. timings --------------------------------------------------------
    fa_t = measure_flash(fa, fa_ref, fa_kernel, gen)
    da_t = measure_decode(da, da_kernel, gen)
    for name, (ms, plain, lib, (bnd, by)) in (("flash_attention", fa_t),
                                              ("decode_attention", da_t)):
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib:.4f} ms, bound {bnd:.5f} ms ({by})")

    # -- 6. the serving path -------------------------------------------------
    fa_kernel.launches = 0
    da_kernel.launches = 0
    ids = serve(SERVE_ARGS)
    launches = {"flash_attention": fa_kernel.launches,
                "decode_attention": da_kernel.launches}
    print(f"serve launches: {launches}")
    if launches["flash_attention"] < LAYERS:
        raise RuntimeError(f"flash kernel launched {launches} times")
    if launches["decode_attention"] < LAYERS * GEN:
        raise RuntimeError(f"decode kernel launched {launches} times")
    cfg = get_config("qwen2-0.5b")
    if ids.shape != (B, GEN + 1) or not ((ids >= 0)
                                         & (ids < cfg.vocab_size)).all():
        raise RuntimeError(f"bad ids: shape {ids.shape}")

    # the same weights and prompts as the served run (same seeds), through
    # the kernels, through the plain versions, and in fp32 throughout
    model = build_model(cfg)
    params = init_params(model.specs(),
                         torch.Generator("cuda").manual_seed(0), "cuda")
    tokens = model.make_batch(torch.Generator("cuda").manual_seed(1),
                              batch=B, seq=S)["tokens"]
    k_logits, k_toks = run_path(model, params, tokens)
    if not torch.equal(k_toks[0].to(torch.int32), torch.as_tensor(
            ids[:, 0], device="cuda")):
        raise RuntimeError("re-run prefill disagrees with the served run")
    with plain_attention(fa, da):
        p_logits, _ = run_path(model, params, tokens, forced=k_toks)
        with fp32_compute():
            r_logits, _ = run_path(model, params, tokens, forced=k_toks)
    check_model(k_logits, p_logits, r_logits)
    profile_serving(model, params, tokens)

    # -- 7. report -----------------------------------------------------------
    kernels = []
    for name, replaces, err, (ms, plain, lib, (bnd, by)) in (
            ("flash_attention",
             "src/repro/kernels/flash_attention/kernel.py:91", fa_err, fa_t),
            ("decode_attention",
             "src/repro/kernels/decode_attention/kernel.py:83", da_err, da_t)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
