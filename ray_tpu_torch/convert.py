"""The JAX package's GPT parameter tree <-> the port's weights.

The JAX tree (``gpt_init``'s output as numpy, e.g.
``jax.tree.map(np.asarray, params)``) stacks every block weight along a
leading ``[n_layer, ...]`` axis; the port keeps one ``Block`` module per
layer, so ``blocks.<i>.<name>`` is slice i of ``blocks[name]``. Shapes and
the ``[in, out]`` matmul layout are the same on both sides.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models.gpt import Block, GPTConfig

_TOP = ("wte", "wpe", "ln_f_scale", "ln_f_bias")


def gpt_params_from_numpy(tree: dict, cfg: GPTConfig) -> dict:
    """JAX tree of numpy arrays -> the port's state dict (f32 CPU
    tensors; ``GPT.load_state_dict`` casts them to each parameter's dtype
    and device)."""
    out = {name: torch.from_numpy(np.array(tree[name], np.float32))
           for name in _TOP}
    blocks = tree["blocks"]
    if set(blocks) != set(Block.SHAPES):
        raise ValueError(f"unexpected block weights {sorted(blocks)}")
    for name, arr in blocks.items():
        arr = np.array(arr, np.float32)
        if arr.shape[0] != cfg.n_layer:
            raise ValueError(
                f"blocks.{name} stacks {arr.shape[0]} layers, config has "
                f"{cfg.n_layer}"
            )
        for i in range(cfg.n_layer):
            out[f"blocks.{i}.{name}"] = torch.from_numpy(arr[i].copy())
    return out


def gpt_params_to_numpy(state: dict, cfg: GPTConfig) -> dict:
    """The port's state dict -> the JAX tree layout, as f32 numpy."""
    def np32(t):
        return t.detach().to("cpu", torch.float32).numpy()

    tree = {name: np32(state[name]) for name in _TOP}
    tree["blocks"] = {
        name: np.stack([np32(state[f"blocks.{i}.{name}"])
                        for i in range(cfg.n_layer)])
        for name in Block.SHAPES
    }
    return tree
