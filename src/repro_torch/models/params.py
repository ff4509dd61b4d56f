"""Parameter specification trees.

A model is described by a nested dict of :class:`ParamSpec` leaves (shape,
logical axes, initializer).  ``init_params`` materialises one on a device
from an explicit ``torch.Generator``; ``params_from_numpy`` carries a tree
of numpy arrays (for example the JAX package's parameters after
``jax.tree.map(np.asarray, params)``) across leaf for leaf.  Layers are
stacked with a leading ``[L, ...]`` dim, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # stddev override
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def spec(shape: Sequence[int], axes: Sequence[str | None], init: str = "normal",
         scale: float | None = None,
         dtype: torch.dtype = torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, scale, dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _fan_in(shape: tuple[int, ...]) -> int:
    # stacked-layer params carry a leading "layers" dim; fan-in is dim -2
    return shape[-2] if len(shape) >= 2 else shape[-1]


def init_leaf(s: ParamSpec, generator: torch.Generator,
              device: torch.device | str) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    std = s.scale if s.scale is not None else 1.0 / math.sqrt(_fan_in(s.shape))
    x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * std).to(device=device, dtype=s.dtype)


def init_params(specs, generator: torch.Generator,
                device: torch.device | str):
    """Materialise a spec tree.  Draws run on the generator's device, so a
    CUDA generator fills a CUDA model without a host round trip."""
    return _map(lambda s: init_leaf(s, generator, device), specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in _leaves(specs))


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")         # a writable copy
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: same bits as torch's
        a = a.view(np.uint16)
        return torch.from_numpy(a).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device: torch.device | str):
    """A nested dict of numpy arrays -> the same tree of tensors on
    ``device``, with the same keys, shapes and dtypes (bf16 included)."""
    return _map(lambda a: _tensor_from_numpy(a, device), tree)
