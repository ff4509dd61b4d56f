"""Unified model API: one `Model` facade per architecture family.

    m = build_model(cfg)
    m.specs()                         -> ParamSpec tree
    m.forward(params, batch)          -> (logits, aux)
    m.cache_specs(batch, s_max)       -> ParamSpec tree (decode state)
    m.decode_step(params, cache, tokens, pos) -> (logits [B, V], cache)
    m.make_batch(generator, batch=, seq=) -> synthetic prompts

Only the dense family is ported so far.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import transformer as tf_model
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    _specs: Callable[[ModelConfig], Any]
    _forward: Callable
    _cache_specs: Callable
    _decode: Callable

    def specs(self):
        return self._specs(self.cfg)

    def forward(self, params, batch, **kw):
        return self._forward(params, batch, self.cfg, **kw)

    def cache_specs(self, batch: int, s_max: int):
        return self._cache_specs(self.cfg, batch, s_max)

    def decode_step(self, params, cache, tokens, pos):
        return self._decode(params, cache, tokens, pos, self.cfg)

    def make_batch(self, generator: torch.Generator, *, batch: int,
                   seq: int):
        """Synthetic prompt batch {"tokens": [B, S]}, drawn on the
        generator's device."""
        return {"tokens": torch.randint(0, self.cfg.vocab_size, (batch, seq),
                                        generator=generator,
                                        device=generator.device)}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "dense":
        return Model(cfg, tf_model.transformer_specs, tf_model.forward,
                     tf_model.init_cache_specs, tf_model.decode_step)
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet; only 'dense' is")
