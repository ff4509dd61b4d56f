"""The port's dense transformer against the JAX package on reduced
qwen2-0.5b, on the CPU, with the JAX parameters carried across by
``params_from_numpy``.

Tolerance of the model comparisons: rtol = atol = 2e-2, the bf16 tolerance
of the reference kernel tests.  Both packages compute in bf16 but round at
different points (XLA fuses the bias add, the residual adds and the casts
around the norms; PyTorch rounds after each op), so a logit differs by a
few bf16 steps.  Measured on this configuration: at most 8.8e-3 on logits
of magnitude below 1 (about two bf16 steps).  The K/V rows written into
the cache reach |x| ~ 5, and there the packages differ by up to 3.1e-2, one
bf16 step at that magnitude; an upstream step of difference also moves small
entries by as much, so the cache is held to an absolute 1e-2 * max|cache|
(about two and a half bf16 steps at the top of its range).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro.models.params import count_params as jax_count_params  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.runtime.steps import build_decode_step as jax_decode_step  # noqa: E402
from repro.runtime.steps import build_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import (count_params, init_params,  # noqa: E402
                                       params_from_numpy)
from repro_torch.runtime.steps import (build_decode_step,  # noqa: E402
                                       build_prefill_step)

TOL = dict(rtol=2e-2, atol=2e-2)
ARCH = "qwen2-0.5b"


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def qwen2():
    """Reduced qwen2 in both packages, with the same parameters.  The QKV
    biases and norm weights, zero and one at init, are drawn at random so
    that their paths are compared too."""
    cfg = jax_get_config(ARCH).reduced()
    jm = jax_build_model(cfg)
    tree = jax.tree.map(np.asarray, jax_init_params(jm.specs(),
                                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    blocks = tree["blocks"]
    for k in ("bq", "bk", "bv"):
        blocks["attn"][k] = 0.5 * rng.standard_normal(
            blocks["attn"][k].shape).astype(np.float32)
    for k in ("ln1", "ln2"):
        blocks[k] = (1 + 0.1 * rng.standard_normal(blocks[k].shape)).astype(
            np.float32)
    return dict(cfg=cfg, jm=jm, tm=build_model(get_config(ARCH).reduced()),
                tree=tree, jparams=jax.tree.map(jnp.asarray, tree),
                tparams=params_from_numpy(tree, "cpu"))


def test_config_copy_matches_reference():
    for arch in ARCH_IDS:
        assert get_config(arch) .__dict__ == jax_get_config(arch).__dict__
    assert get_config(ARCH).reduced().__dict__ == \
        jax_get_config(ARCH).reduced().__dict__


def test_spec_trees_match_reference():
    """Full-width qwen2: the same leaves, shapes and parameter count."""
    jspecs = jax_build_model(jax_get_config(ARCH)).specs()
    tspecs = build_model(get_config(ARCH)).specs()
    jflat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: hasattr(s, "axes"))[0]
    jshapes = {jax.tree_util.keystr(p): s.shape for p, s in jflat}

    def walk(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{prefix}['{k}']")
        else:
            yield prefix, t.shape
    assert dict(walk(tspecs)) == jshapes
    assert count_params(tspecs) == jax_count_params(jspecs)
    assert 0.49e9 < count_params(tspecs) < 0.5e9


def test_params_from_numpy_keeps_keys_shapes_dtypes(qwen2):
    cache = jax.tree.map(np.asarray, jax_init_params(
        qwen2["jm"].cache_specs(2, 16), jax.random.PRNGKey(1)))
    cache["k"] = np.asarray(jnp.asarray(
        np.random.default_rng(1).standard_normal(cache["k"].shape),
        jnp.bfloat16))
    got = params_from_numpy(cache, "cpu")
    assert got["k"].dtype == torch.bfloat16 and got["v"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["k"].float().numpy(),
                                  cache["k"].astype(np.float32))
    t = qwen2["tparams"]
    assert t["blocks"]["attn"]["wq"].dtype == torch.float32
    np.testing.assert_array_equal(t["blocks"]["attn"]["wq"].numpy(),
                                  qwen2["tree"]["blocks"]["attn"]["wq"])


def test_init_params_follows_the_generator():
    specs = build_model(get_config(ARCH).reduced()).specs()
    a = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    b = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    c = init_params(specs, torch.Generator().manual_seed(4), "cpu")
    assert torch.equal(a["embedding"], b["embedding"])
    assert not torch.equal(a["embedding"], c["embedding"])
    assert torch.all(a["blocks"]["attn"]["bq"] == 0)
    assert torch.all(a["final_norm"] == 1)
    assert abs(a["embedding"].std().item() - 0.02) < 2e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope_pct", [1.0, 0.25])
def test_norm_and_rope_match_reference(rope_pct, dtype):
    """rms_norm and (partial) RoPE, as the attention applies them."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 3, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 12)).astype(np.int32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = TOL if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        _np(layers.rms_norm(tx, torch.from_numpy(w))),
        _np(jlayers.rms_norm(jx, jnp.asarray(w))), **tol)
    kw = dict(theta=1_000_000.0, rope_pct=rope_pct)
    got = layers.apply_rope(tx, torch.from_numpy(pos), **kw)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    rot = int(32 * rope_pct)
    assert torch.equal(got[..., rot:], tx[..., rot:])


def test_prefill_matches_reference(qwen2):
    rng = np.random.default_rng(6)
    toks = rng.integers(0, qwen2["cfg"].vocab_size, (3, 40)).astype(np.int32)
    want = jax_prefill_step(qwen2["jm"])[0](qwen2["jparams"],
                                           {"tokens": jnp.asarray(toks)})
    got = build_prefill_step(qwen2["tm"])[0](
        qwen2["tparams"], {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (3, qwen2["cfg"].vocab_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_three_decode_steps_match_reference(qwen2):
    """Three successive steps from a filled cache, rows at different
    positions: logits and the whole cache after each step.  Both get the
    JAX step's greedy tokens, so the two runs stay on one path."""
    cfg = qwen2["cfg"]
    b, smax = 3, 64
    rng = np.random.default_rng(7)
    shape = (cfg.num_layers, b, smax, cfg.num_kv_heads, cfg.head_dim)
    jcache = {n: jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
              for n in ("k", "v")}
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    pos = np.array([10, 25, 40], np.int32)
    tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    jstep = jax_decode_step(qwen2["jm"], batch=b, s_max=smax)[0]
    tstep = build_decode_step(qwen2["tm"])[0]
    for i in range(3):
        jtok, jlogits, jcache = jstep(qwen2["jparams"], jcache,
                                      jnp.asarray(tok), jnp.asarray(pos + i))
        ttok, tlogits, tcache = tstep(qwen2["tparams"], tcache,
                                      torch.tensor(tok).long(),
                                      torch.tensor(pos + i).long())
        assert ttok.shape == (b,) and ttok.dtype == torch.int32
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
        for n in ("k", "v"):
            want = _np(jcache[n])
            np.testing.assert_allclose(_np(tcache[n]), want, rtol=0,
                                       atol=1e-2 * np.abs(want).max())
        tok = np.asarray(jtok)[:, None]


def test_decode_writes_the_cache_in_place(qwen2):
    cfg = qwen2["cfg"]
    cache = init_params(qwen2["tm"].cache_specs(2, 16), None, "cpu")
    k_before = cache["k"]
    step = build_decode_step(qwen2["tm"])[0]
    _, _, out = step(qwen2["tparams"], cache, torch.tensor([[1], [2]]),
                     torch.tensor([3, 7]))
    assert out["k"] is k_before
    written = k_before[:, [0, 1], [3, 7]]
    assert written.abs().sum() > 0
    assert k_before[:, 0, :3].abs().sum() == 0
    assert cache["v"].shape == (cfg.num_layers, 2, 16, cfg.num_kv_heads,
                                cfg.head_dim)


def test_build_model_rejects_families_not_ported():
    for arch in ("rwkv6-1.6b", "zamba2-1.2b", "whisper-tiny",
                 "qwen3-moe-30b-a3b", "qwen2-vl-7b"):
        with pytest.raises(NotImplementedError):
            build_model(get_config(arch))
