"""The port's serving entry point on the CPU, at the reduced config."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate, serve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

ARGS = ["--device", "cpu", "--requests", "3", "--prompt-len", "12",
        "--gen-len", "5", "--cache-len", "24"]


def test_serve_returns_ids_of_the_right_shape(capsys):
    ids = serve(ARGS)
    vocab = get_config("qwen2-0.5b").reduced().vocab_size
    assert ids.shape == (3, 6)
    assert ids.dtype == np.int32
    assert ((ids >= 0) & (ids < vocab)).all()
    out = capsys.readouterr().out
    assert "prefill: 3 x 12 tokens" in out and "tok/s" in out


def test_serve_is_seeded():
    assert np.array_equal(serve(ARGS), serve(ARGS))
    assert not np.array_equal(serve(ARGS), serve(ARGS + ["--seed", "1"]))


def test_serve_asks_for_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(ARGS[2:])


def test_generate_decodes_what_prefill_would_predict():
    """Greedy decode continues from the prefill's argmax, and the first
    decode step sees that token at position S."""
    model = build_model(get_config("qwen2-0.5b").reduced())
    params = init_params(model.specs(), torch.Generator().manual_seed(0),
                         "cpu")
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    ids, first, last, _, _ = generate(model, params, tokens, gen_len=3,
                                      cache_len=16)
    assert torch.equal(ids[:, 0], first.argmax(-1).to(torch.int32))
    assert torch.equal(ids[:, -1], last.argmax(-1).to(torch.int32))
    assert torch.isfinite(first).all() and torch.isfinite(last).all()
    with pytest.raises(ValueError, match="fit"):
        generate(model, params, tokens, gen_len=9, cache_len=16)
