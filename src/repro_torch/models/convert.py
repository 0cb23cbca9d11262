"""Carry the JAX reference's LM parameters into the port's ``LM`` module.

``params_from_jax(cfg, tree)`` takes the reference's parameter tree with
numpy leaves (``jax.tree.map(np.asarray, params)``) in the reference's own
layout: per-layer leaves stacked on a leading (L, ...) axis, ``wd_`` for the
MLP down projection, ``embed`` with its padded vocab rows.  bfloat16 leaves
are taken bit for bit through a ``uint16`` view, so the port needs no numpy
bfloat16 type.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM


def _tensor(leaf, name: str) -> torch.Tensor:
    a = np.array(leaf, order="C")  # a writable copy for torch.from_numpy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype != np.float32:
        raise TypeError(f"params_from_jax: {name} has dtype {a.dtype}")
    return torch.from_numpy(a)


def _copy(dst: torch.nn.Parameter, leaf, name: str) -> None:
    src = _tensor(leaf, name)
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"params_from_jax: {name} is {tuple(src.shape)} {src.dtype}, "
                         f"the model wants {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


@torch.no_grad()
def params_from_jax(cfg: ModelConfig, tree: Mapping, device=None) -> LM:
    """The reference's parameters (numpy leaves) → the port's ``LM`` on
    ``device`` (``cuda`` unless named).  Every leaf must be used and match
    the model's shape and dtype."""
    model = LM(cfg, device)
    blocks = dict(tree["blocks"])
    top = {k: v for k, v in tree.items() if k != "blocks"}
    for name, p in model.named_parameters(recurse=False):
        if name not in top:
            raise KeyError(f"params_from_jax: the tree has no {name!r}")
        _copy(p, top.pop(name), name)
    names = set(dict(model.blocks[0].named_parameters()))
    if names != set(blocks) or top:
        raise KeyError(f"params_from_jax: tree leaves {sorted(set(blocks) | set(top))} do not "
                       f"match the model's {sorted(names)}")
    for name, stacked in blocks.items():
        if len(stacked) != cfg.n_layers:
            raise ValueError(f"params_from_jax: blocks.{name} stacks {len(stacked)} layers, "
                             f"not {cfg.n_layers}")
        for i, blk in enumerate(model.blocks):
            _copy(getattr(blk, name), stacked[i], f"blocks.{name}[{i}]")
    return model
