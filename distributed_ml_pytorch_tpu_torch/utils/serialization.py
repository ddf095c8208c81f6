"""Flat-parameter serialization: the wire layout of the DownPour vector.

Counterpart of the JAX ``utils/serialization.py``. A push, a pull reply and
the server's central vector ARE this flat float32 vector, so the port must
lay it out exactly as ``jax.flatten_util.ravel_pytree`` lays out the flax
param tree of the same model:

- layers in sorted module-name order (``classifier``, ``conv1`` … ``conv5``;
  ``conv1``, ``conv2``, ``fc1`` …), and ``bias`` before ``kernel`` in each;
- each leaf in its JAX layout: a conv kernel as HWIO (the port's weight is
  OIHW), a dense kernel as ``(in, out)`` (the port's is ``(out, in)``).

``ravel_model_params(model)`` emits that vector; ``unravel_model_params``
writes one back into the model's parameters in place (the reference's
in-place contract; the port installs pulled parameters between steps, so no
step ever sees a torn model).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

#: (layer name, leaf kind) — kind is "bias", "conv" or "dense"
Leaf = Tuple[str, str]


def leaf_order(model: nn.Module) -> List[Leaf]:
    """The JAX flat order of ``model``'s layers and leaves."""
    layers = []
    for name, mod in model.named_children():
        if isinstance(mod, nn.Conv2d):
            layers.append((name, "conv"))
        elif isinstance(mod, nn.Linear):
            layers.append((name, "dense"))
        elif any(True for _ in mod.parameters()):
            raise TypeError(f"layer {name!r} ({type(mod).__name__}) has no flat layout")
    out: List[Leaf] = []
    for name, kind in sorted(layers):
        out += [(name, "bias"), (name, kind)]
    return out


def param_name(leaf: Leaf) -> str:
    """The port parameter name of a leaf (``conv1.weight``, ``conv1.bias``)."""
    name, kind = leaf
    return f"{name}.{'bias' if kind == 'bias' else 'weight'}"


def to_jax_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    """A port tensor in the JAX leaf layout (a view where possible)."""
    if kind == "conv":
        return t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    if kind == "dense":
        return t.t()                  # (out, in) -> (in, out)
    return t


def from_jax_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    """The inverse of :func:`to_jax_layout`."""
    if kind == "conv":
        return t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "dense":
        return t.t()
    return t


def ravel_tensors(model: nn.Module, values: Dict[str, torch.Tensor],
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flatten ``values`` (parameter name -> tensor shaped like that
    parameter) into the JAX flat order; ``out`` (optional) receives it."""
    pieces = [to_jax_layout(values[param_name(leaf)], leaf[1]).reshape(-1)
              for leaf in leaf_order(model)]
    if out is None:
        return torch.cat(pieces)
    return torch.cat(pieces, out=out)


def ravel_model_params(model: nn.Module, grads: bool = False) -> torch.Tensor:
    """One flat vector of every parameter (``grads=True``: every gradient),
    laid out exactly as the JAX package's ``ravel_pytree`` lays out the same
    model's flax params."""
    values = {n: (p.grad if grads else p).detach() for n, p in model.named_parameters()}
    return ravel_tensors(model, values)


def make_unraveler(model: nn.Module) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """A function mapping a flat vector to ``{parameter name: tensor}`` in the
    port's layout. Cache it once per model."""
    leaves = leaf_order(model)
    params = dict(model.named_parameters())
    shapes = []
    for leaf in leaves:
        shape = to_jax_layout(params[param_name(leaf)], leaf[1]).shape
        shapes.append((leaf, shape, int(torch.Size(shape).numel())))
    total = sum(n for _, _, n in shapes)

    def unravel(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        if flat.dim() != 1 or flat.numel() != total:
            raise ValueError(f"flat vector of {tuple(flat.shape)} elements, "
                             f"the model has {total} parameters")
        out, off = {}, 0
        for leaf, shape, n in shapes:
            piece = flat[off:off + n].reshape(shape)
            out[param_name(leaf)] = from_jax_layout(piece, leaf[1])
            off += n
        return out

    return unravel


def unravel_model_params(model: nn.Module, flat: torch.Tensor,
                         unravel: Optional[Callable] = None) -> nn.Module:
    """Copy the flat vector ``flat`` into ``model``'s parameters in place."""
    values = (unravel or make_unraveler(model))(flat)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(values[name])
    return model


def flat_size(model: nn.Module) -> int:
    """Total parameter count — the accumulator's unpadded length."""
    return sum(p.numel() for p in model.parameters())
