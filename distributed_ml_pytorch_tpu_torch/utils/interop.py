"""Weights carried across from the JAX package (counterpart of the JAX
``utils/interop.py``, direction reversed).

``params_from_jax`` takes a flax param tree as nested dicts of numpy arrays
(``{"conv1": {"kernel": ..., "bias": ...}, ...}``) and returns the port
model's ``state_dict``:

- conv kernels: flax HWIO -> torch OIHW;
- dense kernels: flax ``(in, out)`` -> torch ``(out, in)``;
- biases unchanged.

No flatten permutation is needed: the port's models flatten in HWC order, as
the JAX models flatten NHWC, so LeNet's ``fc1`` is only transposed.
``params_to_jax`` is the inverse. Neither imports JAX; the tree is plain
numpy.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from distributed_ml_pytorch_tpu_torch.utils.serialization import (
    from_jax_layout,
    leaf_order,
    param_name,
    to_jax_layout,
)


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                    model: nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` for ``model`` holding the flax params ``tree``.

    Every layer of ``model`` must be in ``tree`` with matching shapes, and
    ``tree`` must hold nothing else; a mismatch raises ``ValueError``.
    """
    params = dict(model.named_parameters())
    layers = {name for name, _ in leaf_order(model)}
    extra = set(tree) - layers
    if extra:
        raise ValueError(f"flax tree has layers the model lacks: {sorted(extra)}")
    out: Dict[str, torch.Tensor] = {}
    for name, kind in leaf_order(model):
        if name not in tree:
            raise ValueError(f"flax tree lacks layer {name!r}")
        leaf = "bias" if kind == "bias" else "kernel"
        arr = torch.from_numpy(np.array(tree[name][leaf], dtype=np.float32))
        t = from_jax_layout(arr, kind).contiguous()
        pname = param_name((name, kind))
        if t.shape != params[pname].shape:
            raise ValueError(f"{name}/{leaf}: flax {tuple(arr.shape)} -> "
                             f"{tuple(t.shape)}, model {tuple(params[pname].shape)}")
        out[pname] = t
    return out


def params_to_jax(model: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    """The flax param tree (nested dicts of numpy) of ``model``'s weights."""
    params = dict(model.named_parameters())
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for name, kind in leaf_order(model):
        pname = param_name((name, kind))
        t = to_jax_layout(params[pname].detach().cpu(), kind)
        tree.setdefault(name, {})["bias" if kind == "bias" else "kernel"] = (
            t.contiguous().numpy().copy())
    return tree
