"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip elsewhere.  The file imports no
JAX, so that it runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference kernel tests': 2e-4 in fp32 and 2e-2 in bf16.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


FLASH = [  # (b, sq, skv, h, kvh, d, mask kwargs)
    (2, 128, 128, 4, 2, 32, {}),
    (1, 256, 256, 4, 4, 64, dict(window=48)),
    (2, 96, 96, 2, 1, 16, dict(chunk=64)),
    (2, 64, 64, 4, 2, 32, dict(causal=False)),
    (1, 40, 72, 4, 2, 32, dict(causal=False)),
    (1, 64, 192, 2, 2, 32, dict(q_offset=128)),
    (2, 77, 77, 6, 2, 128, dict(chunk=32)),
    (1, 64, 64, 2, 1, 64, dict(window=8, q_offset=50)),
    (8, 256, 256, 14, 2, 64, {}),                      # qwen2-0.5b prefill
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,kw", FLASH)
def test_flash_kernel_matches_plain(dev, b, sq, skv, h, kvh, d, kw, dtype):
    q = _randn((b, sq, h, d), dtype, dev, 0)
    k = _randn((b, skv, kvh, d), dtype, dev, 1)
    v = _randn((b, skv, kvh, d), dtype, dev, 2)
    before = fa_kernel.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa_kernel.launches == before + 1
    _close(got, fa.flash_attention_torch(q, k, v, **kw), dtype)


DECODE = [  # (b, smax, h, kvh, d, valid, pos, mask kwargs)
    (2, 128, 4, 2, 32, [64, 128], None, {}),
    (3, 96, 14, 2, 64, [1, 50, 96], [0, 49, 95], {}),
    (2, 128, 8, 1, 128, [100, 128], [99, 127], dict(window=32)),
    (2, 128, 4, 2, 32, [70, 128], [69, 127], dict(chunk=48)),
    (2, 64, 4, 2, 16, [64, 40], [200, 39], dict(window=64, rolling=True)),
    (8, 512, 14, 2, 64, [257, 260, 270, 288, 300, 400, 511, 512], None, {}),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,smax,h,kvh,d,valid,pos,kw", DECODE)
def test_decode_kernel_matches_plain(dev, b, smax, h, kvh, d, valid, pos, kw,
                                     dtype):
    q = _randn((b, h, d), dtype, dev, 3)
    ck = _randn((b, smax, kvh, d), dtype, dev, 4)
    cv = _randn((b, smax, kvh, d), dtype, dev, 5)
    valid = torch.tensor(valid, device=dev)
    pos = None if pos is None else torch.tensor(pos, device=dev)
    before = da_kernel.launches
    got = da.decode_attention(q, ck, cv, valid, pos=pos, **kw)
    assert da_kernel.launches == before + 1
    _close(got, da.decode_attention_torch(q, ck, cv, valid, pos=pos, **kw),
           dtype)


def test_launchers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 2, 48, device=dev)           # D = 48
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError):                     # not contiguous
        fa.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):                     # mixed dtypes
        fa.flash_attention(q, q.half(), q)
    c = torch.zeros(1, 8, 1, 32, device=dev)
    with pytest.raises(ValueError):                     # group of 16 > 8
        da.decode_attention(torch.zeros(1, 16, 32, device=dev), c, c,
                            torch.tensor([8], device=dev))


def test_reduced_qwen2_on_the_card_matches_the_cpu(dev):
    """Prefill and three greedy decode steps through both kernels, against
    the plain versions on the CPU with the same weights and tokens."""
    model = build_model(get_config("qwen2-0.5b").reduced())
    params = init_params(model.specs(), torch.Generator().manual_seed(0),
                         "cpu")
    tokens = torch.randint(0, model.cfg.vocab_size, (3, 40),
                           generator=torch.Generator().manual_seed(1))
    on_card = init_params(model.specs(), torch.Generator().manual_seed(0),
                          dev)
    ids, first, last, _, _ = generate(model, on_card, tokens.to(dev),
                                      gen_len=3, cache_len=64)
    ids_cpu, first_cpu, _, _, _ = generate(model, params, tokens, gen_len=3,
                                           cache_len=64)
    torch.testing.assert_close(first.cpu(), first_cpu, rtol=2e-2, atol=2e-2)
    assert torch.isfinite(last).all()
    assert ids.shape == ids_cpu.shape == (3, 4)
