"""The port's plain attention versions against the JAX package's oracles
and its chunked flash path, on the CPU, over the reference sweep
(tests/test_kernels.py) and the mask cases the port adds: non-causal,
Sq != Skv, q_offset, window, chunk, rolling and pos given.

Inputs are drawn with numpy from a seed and handed to both packages; bf16
inputs are rounded once, identically on both sides.  Tolerances are the
reference kernel tests': 2e-4 in fp32 (summation order only) and 2e-2 in
bf16 (the output is rounded to bf16, whose spacing near 1 is 7.8e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import ref as jda_ref  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """The same normal draw as a JAX array and a torch tensor."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(TOL32 if dtype == "float32" else TOL))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

SWEEP = [(2, 128, 128, 4, 2, 32), (1, 256, 256, 4, 4, 64),
         (2, 96, 96, 2, 1, 16)]
MASKS = {"causal": dict(causal=True),
         "window": dict(causal=True, window=48),
         "chunk": dict(causal=True, chunk=64)}
EXTRA = [  # (b, sq, skv, h, kvh, d, mask kwargs)
    (2, 64, 64, 4, 2, 32, dict(causal=False)),                  # whisper encoder
    (1, 40, 72, 4, 2, 32, dict(causal=False)),                  # Sq != Skv
    (1, 64, 192, 2, 2, 32, dict(causal=True, q_offset=128)),    # continuation
    (1, 48, 112, 4, 1, 64, dict(causal=True, q_offset=64, window=40)),
    (2, 77, 77, 6, 2, 128, dict(causal=True, chunk=32)),        # ragged, D=128
    (1, 64, 64, 2, 1, 32, dict(causal=True, window=1)),
    (1, 64, 64, 2, 1, 64, dict(causal=True, window=8, q_offset=50)),  # dead rows
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,skv,h,kvh,d", SWEEP)
@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_attention_matches_jax(b, sq, skv, h, kvh, d, dtype, mask):
    rng = np.random.default_rng(0)
    jq, q = _pair(rng, (b, sq, h, d), dtype)
    jk, k = _pair(rng, (b, skv, kvh, d), dtype)
    jv, v = _pair(rng, (b, skv, kvh, d), dtype)
    kw = MASKS[mask]
    want = jfa_ref.mha_reference(jq, jk, jv, **kw)
    _close(fa_ref.mha_reference(q, k, v, **kw), want, dtype)
    _close(fa.flash_attention_torch(q, k, v, **kw), want, dtype)
    # the JAX package's own chunked path agrees with the port's
    _close(fa.flash_attention_torch(q, k, v, block_k=32, **kw),
           jfa.flash_attention_jnp(jq, jk, jv, block_k=32, **kw), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,kw", EXTRA)
def test_flash_attention_masks_match_jax(b, sq, skv, h, kvh, d, kw, dtype):
    rng = np.random.default_rng(1)
    jq, q = _pair(rng, (b, sq, h, d), dtype)
    jk, k = _pair(rng, (b, skv, kvh, d), dtype)
    jv, v = _pair(rng, (b, skv, kvh, d), dtype)
    want = jfa_ref.mha_reference(jq, jk, jv, **kw)
    _close(fa_ref.mha_reference(q, k, v, **kw), want, dtype)
    _close(fa.flash_attention(q, k, v, **kw), want, dtype)


def test_flash_attention_dead_rows_are_zero():
    """Rows with no live key give 0: with q_offset far past the window,
    every key is too old for every row."""
    rng = np.random.default_rng(2)
    _, q = _pair(rng, (1, 8, 2, 16), "float32")
    _, k = _pair(rng, (1, 8, 2, 16), "float32")
    _, v = _pair(rng, (1, 8, 2, 16), "float32")
    out = fa.flash_attention(q, k, v, causal=True, window=4, q_offset=100)
    assert torch.equal(out, torch.zeros_like(out))
    ref = fa_ref.mha_reference(q, k, v, causal=True, window=4, q_offset=100)
    assert torch.equal(ref, torch.zeros_like(ref))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE = [  # (b, smax, h, kvh, d, valid, pos, mask kwargs)
    (2, 128, 4, 2, 32, [64, 128], None, {}),                    # reference sweep
    (3, 64, 2, 2, 64, [32, 64, 57], None, {}),
    (3, 96, 14, 2, 64, [1, 50, 96], [0, 49, 95], {}),           # group 7, valid 1
    (2, 128, 8, 1, 128, [100, 128], [99, 127], dict(window=32)),
    (2, 128, 4, 2, 32, [70, 128], [69, 127], dict(chunk=48)),
    (2, 64, 4, 2, 16, [64, 40], [200, 39], dict(window=64, rolling=True)),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,smax,h,kvh,d,valid,pos,kw", DECODE)
def test_decode_attention_matches_jax(b, smax, h, kvh, d, valid, pos, kw,
                                      dtype):
    rng = np.random.default_rng(3)
    jq, q = _pair(rng, (b, h, d), dtype)
    jck, ck = _pair(rng, (b, smax, kvh, d), dtype)
    jcv, cv = _pair(rng, (b, smax, kvh, d), dtype)
    jvalid, tvalid = jnp.asarray(valid), torch.tensor(valid)
    jpos = None if pos is None else jnp.asarray(pos)
    tpos = None if pos is None else torch.tensor(pos)
    want = jda_ref.decode_reference(jq, jck, jcv, jvalid, pos=jpos, **kw)
    _close(da_ref.decode_reference(q, ck, cv, tvalid, pos=tpos, **kw), want,
           dtype)
    _close(da.decode_attention(q, ck, cv, tvalid, pos=tpos, **kw), want,
           dtype)


def test_decode_pos_none_follows_the_kernel():
    """pos=None: the port (like the Pallas kernel) takes pos = valid - 1
    and keeps the window mask; the JAX oracle drops it."""
    rng = np.random.default_rng(4)
    _, q = _pair(rng, (2, 4, 32), "float32")
    _, ck = _pair(rng, (2, 64, 2, 32), "float32")
    _, cv = _pair(rng, (2, 64, 2, 32), "float32")
    valid = torch.tensor([64, 20])
    got = da.decode_attention(q, ck, cv, valid, window=16)
    want = da_ref.decode_reference(q, ck, cv, valid, pos=valid - 1, window=16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    unmasked = da_ref.decode_reference(q, ck, cv, valid, window=16)
    assert not torch.allclose(got, unmasked)


# ---------------------------------------------------------------------------
# the CUDA launchers refuse what the kernels do not take
# ---------------------------------------------------------------------------

def test_launchers_refuse_cpu_tensors_without_launching():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 8, 1, 16)
    before = (fa_kernel.launches, da_kernel.launches)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError):
        da_kernel.decode_attention_cuda(q[:, 0], k, k, torch.tensor([8]))
    fa.flash_attention(q, k, k)
    da.decode_attention(q[:, 0], k, k, torch.tensor([8]))
    assert (fa_kernel.launches, da_kernel.launches) == before


# ---------------------------------------------------------------------------
# the nvcc build, with a stand-in compiler
# ---------------------------------------------------------------------------

FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out=$2; fi
  shift
done
echo "ptxas info    : Used 10 registers"
[ -n "$FAIL" ] && exit 1
echo built >> "$COUNT"
touch "$out"
"""


def test_build_compiles_each_source_once(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    count = tmp_path / "count"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("COUNT", str(count))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.build()
    assert count.read_text().count("built") == len(_build.NAMES)
    for name in _build.NAMES:
        assert _build.library(name).exists()
        assert "registers" in _build.build_log(name)
    _build.build()                       # up to date: no second compile
    assert count.read_text().count("built") == len(_build.NAMES)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    monkeypatch.setenv("FAIL", "1")      # new flags, new hash: a rebuild
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build(("flash_attention",))
    assert not _build.library("flash_attention").exists()
