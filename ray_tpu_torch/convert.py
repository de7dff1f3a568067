"""The JAX package's GPT parameter tree <-> the port's weights.

The JAX tree (``gpt_init``'s output as numpy, e.g.
``jax.tree.map(np.asarray, params)``) stacks every block weight along a
leading ``[n_layer, ...]`` axis; the port keeps one ``Block`` module per
layer, so ``blocks.<i>.<name>`` is slice i of ``blocks[name]``. Shapes and
the ``[in, out]`` matmul layout are the same on both sides.

A quantized JAX tree (``quantize_params`` output mapped to numpy) holds
``QuantizedTensor`` leaves with numpy ``data`` and ``scale``; they arrive
as the port's ``QuantizedTensor`` with the same bytes, so both packages
serve the same quantized weights. fp8 data comes as an ``ml_dtypes``
array and crosses as its bytes (viewed as uint8, then as
``torch.float8_e4m3fn``).
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models.gpt import _TOP, Block, GPTConfig
from ray_tpu_torch.ops.quantization import QuantizedTensor

# numpy dtype name of each quantized storage dtype the JAX package writes
_QUANT_NP = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}


def _quant_data(arr) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name not in _QUANT_NP:
        raise TypeError(f"quantized data of dtype {arr.dtype} is not int8 "
                        f"or float8_e4m3fn")
    return torch.from_numpy(arr.view(np.uint8).copy()).view(
        _QUANT_NP[arr.dtype.name])


def _leaf(x, layer: int | None = None):
    """One leaf (a layer's slice of it when ``layer`` is given) as an f32
    tensor, or a QuantizedTensor for a quantized leaf."""
    if hasattr(x, "scale"):  # the JAX QuantizedTensor, duck-typed
        data, scale = np.asarray(x.data), np.asarray(x.scale, np.float32)
        if layer is not None:
            data, scale = data[layer], scale[layer]
        return QuantizedTensor(_quant_data(data),
                               torch.from_numpy(scale.copy()))
    arr = np.array(x, np.float32)
    return torch.from_numpy(arr if layer is None else arr[layer].copy())


def gpt_params_from_numpy(tree: dict, cfg: GPTConfig) -> dict:
    """JAX tree of numpy arrays -> the port's state dict (f32 CPU tensors,
    or QuantizedTensors for quantized leaves; ``GPT.load_weights`` copies
    them to each weight's dtype and device)."""
    out = {name: _leaf(tree[name]) for name in _TOP}
    blocks = tree["blocks"]
    if set(blocks) != set(Block.SHAPES):
        raise ValueError(f"unexpected block weights {sorted(blocks)}")
    for name, arr in blocks.items():
        if arr.shape[0] != cfg.n_layer:
            raise ValueError(
                f"blocks.{name} stacks {arr.shape[0]} layers, config has "
                f"{cfg.n_layer}"
            )
        for i in range(cfg.n_layer):
            out[f"blocks.{i}.{name}"] = _leaf(arr, i)
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
