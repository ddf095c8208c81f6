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

A ``TransformerLM`` names its modules as the flax model does, so its leaves
map by name: ``tok_embed/embedding``, ``pos_embed/embedding``,
``block_i/LayerNorm_{0,1}/{scale,bias}``, ``block_i/attn/{q,k,v,o}/kernel``
(or ``attn/qkv`` under ``fused_qkv``), ``block_i/Dense_{0,1}/{kernel,bias}``,
``LayerNorm_0/{scale,bias}`` and ``lm_head/kernel``. Dense kernels transpose
from ``(in, out)`` to ``(out, in)``; embeddings and LayerNorm parameters are
unchanged. A ``fused_qkv`` model also takes a tree in the unfused layout: its
``attn/{q,k,v}`` kernels are concatenated on the output axis first, as the
JAX decode path's ``_fuse_qkv_params`` does.

``params_to_jax`` is the inverse. ``cache_from_jax`` / ``cache_to_jax`` carry
a decode cache (the flax ``"cache"`` collection as nested dicts of numpy)
to and from the port's cache dict, leaf for leaf under the same names;
bfloat16 leaves travel as their bits (read by dtype name through
``.view(np.uint16)``, returned as ``np.uint16``). None of these imports JAX
or ``ml_dtypes``; the trees are plain numpy.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

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
    if _is_lm(model):
        return _lm_from_jax(tree, model)
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
    if _is_lm(model):
        return _lm_to_jax(model)
    params = dict(model.named_parameters())
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for name, kind in leaf_order(model):
        pname = param_name((name, kind))
        t = to_jax_layout(params[pname].detach().cpu(), kind)
        tree.setdefault(name, {})["bias" if kind == "bias" else "kernel"] = (
            t.contiguous().numpy().copy())
    return tree


# ------------------------------------------------------------------ TransformerLM

def _is_lm(model: nn.Module) -> bool:
    from distributed_ml_pytorch_tpu_torch.models.transformer import TransformerLM

    return isinstance(model, TransformerLM)


def _lm_leaves(model: nn.Module) -> List[Tuple[Tuple[str, ...], str, bool]]:
    """``(flax path, port parameter name, transpose)`` for every parameter of
    a ``TransformerLM``."""
    from distributed_ml_pytorch_tpu_torch.models.transformer import Dense, Embed, LayerNorm

    mods = dict(model.named_modules())
    out = []
    for pname, _ in model.named_parameters():
        owner, leaf = pname.rsplit(".", 1)
        mod = mods[owner]
        if isinstance(mod, Dense):
            name, transpose = ("kernel", True) if leaf == "weight" else ("bias", False)
        elif isinstance(mod, Embed):
            name, transpose = "embedding", False
        elif isinstance(mod, LayerNorm):
            name, transpose = ("scale" if leaf == "weight" else "bias"), False
        else:
            raise TypeError(f"parameter {pname!r} ({type(mod).__name__}) has no flax name")
        out.append((tuple(owner.split(".")) + (name,), pname, transpose))
    return out


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = val
    return flat


def _fuse_qkv_tree(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    """Unfused ``…/attn/{q,k,v}/kernel`` leaves as one ``…/attn/qkv/kernel``
    (concatenated on the output axis)."""
    out = {}
    for path, val in flat.items():
        if len(path) >= 3 and path[-3] == "attn" and path[-2] in ("q", "k", "v"):
            if path[-2] == "q":
                out[path[:-2] + ("qkv", "kernel")] = np.concatenate(
                    [np.asarray(flat[path[:-2] + (n, "kernel")]) for n in ("q", "k", "v")],
                    axis=-1)
        else:
            out[path] = val
    return out


def _lm_from_jax(tree: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    flat = _flatten(tree)
    if model.fused_qkv and any(p[-3:] == ("attn", "q", "kernel") for p in flat):
        flat = _fuse_qkv_tree(flat)
    leaves = _lm_leaves(model)
    want = {path for path, _, _ in leaves}
    extra, missing = set(flat) - want, want - set(flat)
    if extra or missing:
        raise ValueError(
            "flax tree does not match the TransformerLM: "
            f"extra {sorted('/'.join(p) for p in extra)}, "
            f"missing {sorted('/'.join(p) for p in missing)}")
    params = dict(model.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    for path, pname, transpose in leaves:
        arr = torch.from_numpy(np.array(flat[path], dtype=np.float32))
        t = (arr.t() if transpose else arr).contiguous()
        if t.shape != params[pname].shape:
            raise ValueError(f"{'/'.join(path)}: flax {tuple(arr.shape)} -> "
                             f"{tuple(t.shape)}, model {tuple(params[pname].shape)}")
        out[pname] = t
    return out


def _lm_to_jax(model: nn.Module) -> Dict:
    params = dict(model.named_parameters())
    tree: Dict = {}
    for path, pname, transpose in _lm_leaves(model):
        t = params[pname].detach().float().cpu()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (t.t() if transpose else t).contiguous().numpy().copy()
    return tree


# ------------------------------------------------------------------ decode cache

def _leaf_from_numpy(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def cache_from_jax(tree: Mapping, device="cpu") -> Dict:
    """The port's decode cache holding the flax cache ``tree`` (nested dicts
    of numpy arrays), leaf for leaf, on ``device``."""
    return {name: (cache_from_jax(val, device) if isinstance(val, Mapping)
                   else _leaf_from_numpy(val, device)) for name, val in tree.items()}


def cache_to_jax(cache: Mapping) -> Dict:
    """The port's decode cache as nested dicts of numpy; bfloat16 leaves as
    their ``np.uint16`` bits (``.view(jnp.bfloat16)`` restores them)."""
    out = {}
    for name, val in cache.items():
        if isinstance(val, Mapping):
            out[name] = cache_to_jax(val)
        elif val.dtype == torch.bfloat16:
            out[name] = val.detach().cpu().view(torch.int16).numpy().view(np.uint16).copy()
        else:
            out[name] = val.detach().cpu().numpy().copy()
    return out
