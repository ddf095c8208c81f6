"""Weights carried across from the JAX package (counterpart of the JAX
``utils/interop.py``, direction reversed).

``params_from_jax`` takes a flax param tree as nested dicts of numpy arrays
(``{"conv1": {"kernel": ..., "bias": ...}, ...}``, nested deeper for a
ResNet: ``{"stage1_block1": {"conv1": {"kernel": ...}, "norm1": {"scale":
..., "bias": ...}}, ...}``) and returns the port model's ``state_dict``:

- conv kernels: flax HWIO -> torch OIHW;
- dense kernels: flax ``(in, out)`` -> torch ``(out, in)``;
- biases and GroupNorm scales unchanged.

No flatten permutation is needed: the port's models flatten in HWC order, as
the JAX models flatten NHWC, so LeNet's ``fc1`` is only transposed.

A ``TransformerLM`` names its modules as the flax model does, so its leaves
map by name: ``tok_embed/embedding``, ``pos_embed/embedding``,
``block_i/LayerNorm_{0,1}/{scale,bias}``, ``block_i/attn/{q,k,v,o}/kernel``
(or ``attn/qkv`` under ``fused_qkv``), ``block_i/Dense_{0,1}/{kernel,bias}``,
``LayerNorm_0/{scale,bias}`` and ``lm_head/kernel``; a ``MoETransformerLM``
has ``block_i/moe/{router/kernel, w_up, b_up, w_down, b_down}`` in place of
the ``Dense`` layers, the stacked expert weights as they are (``w_up`` is
``[E, D, F]`` on both sides). Dense kernels transpose
from ``(in, out)`` to ``(out, in)``; embeddings and LayerNorm parameters are
unchanged. A ``fused_qkv`` model also takes a tree in the unfused layout: its
``attn/{q,k,v}`` kernels are concatenated on the output axis first, as the
JAX decode path's ``_fuse_qkv_params`` does.

The pipelined LM (``parallel/pipeline.py``) stacks its blocks on a
leading layer axis in JAX (``blocks/attn/q/kernel`` is ``[L, D, D]``):
:func:`pp_params_from_jax` unstacks it into the port's ``blocks.{i}.…``
names (``layer_order`` takes the interleaved schedule's storage order,
``blocks[order]``), with ``tok_embed``, ``pos_embed``, ``ln_f`` and
``head`` beside them; ``pipeline.create_pp_train_state`` then keeps each
stage's layers and, under ``model_axis``, cuts their Megatron slices;
:func:`pp_params_to_jax` stacks them back. The two carry one MPMD stage's
tree as well (JAX ``parallel/mpmd.stage_param_tree``: the stage's slice of
the stack, the embeddings on stage 0, ``ln_f`` and ``head`` on the last),
its blocks numbered from 0 as ``parallel/mpmd.StageLM`` holds them. The
expert-parallel and composite states start from :func:`params_from_jax` of the JAX
``MoETransformerLM`` / ``TransformerLM`` tree, and their
``create_*_train_state`` keep this rank's experts or shards.

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
    JAX_LEAF,
    from_jax_layout,
    leaf_order,
    param_name,
    to_jax_layout,
)


def _cnn_leaves(model: nn.Module) -> List[Tuple[Tuple[str, ...], str, str]]:
    """``(flax path, port parameter name, leaf kind)`` for every parameter of
    a CNN (``utils/serialization.leaf_order``)."""
    return [(tuple(name.split(".")) + (JAX_LEAF[kind],), param_name((name, kind)), kind)
            for name, kind in leaf_order(model)]


def _check_paths(flat: Mapping, want, what: str) -> None:
    extra, missing = set(flat) - set(want), set(want) - set(flat)
    if extra or missing:
        raise ValueError(
            f"flax tree does not match the {what}: "
            f"extra {sorted('/'.join(p) for p in extra)}, "
            f"missing {sorted('/'.join(p) for p in missing)}")


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                    model: nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` for ``model`` holding the flax params ``tree``.

    Every leaf of ``model`` must be in ``tree`` with matching shapes, and
    ``tree`` must hold nothing else; a mismatch raises ``ValueError``.
    """
    if _is_lm(model):
        return _lm_from_jax(tree, model)
    flat = _flatten(tree)
    leaves = _cnn_leaves(model)
    _check_paths(flat, [path for path, _, _ in leaves], type(model).__name__)
    params = dict(model.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    for path, pname, kind in leaves:
        arr = torch.from_numpy(np.array(flat[path], dtype=np.float32))
        t = from_jax_layout(arr, kind).contiguous()
        if t.shape != params[pname].shape:
            raise ValueError(f"{'/'.join(path)}: flax {tuple(arr.shape)} -> "
                             f"{tuple(t.shape)}, model {tuple(params[pname].shape)}")
        out[pname] = t
    return out


def params_to_jax(model: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    """The flax param tree (nested dicts of numpy) of ``model``'s weights."""
    if _is_lm(model):
        return _lm_to_jax(model)
    params = dict(model.named_parameters())
    tree: Dict = {}
    for path, pname, kind in _cnn_leaves(model):
        t = to_jax_layout(params[pname].detach().float().cpu(), kind)
        _put(tree, path, t.contiguous().numpy().copy())
    return tree


def _put(tree: Dict, path: Tuple[str, ...], val) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = val


# ------------------------------------------------------------------ TransformerLM

def _is_lm(model: nn.Module) -> bool:
    from distributed_ml_pytorch_tpu_torch.models.transformer import TransformerLM

    return isinstance(model, TransformerLM)


def _lm_leaves(model: nn.Module) -> List[Tuple[Tuple[str, ...], str, bool]]:
    """``(flax path, port parameter name, transpose)`` for every parameter of
    a ``TransformerLM`` or ``MoETransformerLM`` (whose ``moe`` layers hold
    their stacked expert weights under the flax names)."""
    from distributed_ml_pytorch_tpu_torch.models.moe import MoEMLP
    from distributed_ml_pytorch_tpu_torch.models.transformer import Dense, Embed, LayerNorm

    mods = dict(model.named_modules())
    out = []
    for pname, _ in model.named_parameters():
        owner, leaf = pname.rsplit(".", 1)
        mod = mods[owner]
        if isinstance(mod, MoEMLP):
            name, transpose = leaf, False
        elif isinstance(mod, Dense):
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
    _check_paths(flat, [path for path, _, _ in leaves], type(model).__name__)
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
        _put(tree, path, (t.t() if transpose else t).contiguous().numpy().copy())
    return tree


# ------------------------------------------------------------------ pipelined LM

_PP_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def pp_params_from_jax(tree: Mapping, layer_order=None) -> Dict[str, torch.Tensor]:
    """The pipelined LM's whole ``state_dict`` (``parallel/pipeline.
    PipelineLM`` names) from the JAX ``init_pp_params`` tree (nested dicts
    of numpy): the stacked ``blocks`` leaves become ``blocks.{i}.…`` (block
    ``i`` of the stack, or of ``blocks[layer_order]``), dense kernels
    transposed to ``(out, in)``. One MPMD stage's tree gives that stage's
    ``state_dict`` (the leaves it has)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree).items():
        arr = np.asarray(arr, dtype=np.float32)
        owner, leaf = ".".join(path[:-1]), _PP_LEAF[path[-1]]

        def conv(a):
            t = torch.from_numpy(np.array(a))
            return (t.t() if path[-1] == "kernel" else t).contiguous()

        if path[0] == "blocks":
            stack = arr if layer_order is None else arr[np.asarray(layer_order)]
            sub = ".".join(path[1:-1])
            for i in range(stack.shape[0]):
                out[f"blocks.{i}.{sub}.{leaf}"] = conv(stack[i])
        else:
            out[f"{owner}.{leaf}"] = conv(arr)
    return out


def pp_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The JAX ``init_pp_params`` tree (nested dicts of numpy) of a whole
    pipelined ``state_dict``, or the JAX ``stage_param_tree`` of one MPMD
    stage's: blocks stacked on the leading layer axis."""
    kinds = {"tok_embed": "embedding", "pos_embed": "embedding", "ln_f": None, "head": "kernel"}
    stacks: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    tree: Dict = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        a = t.detach().float().cpu()
        if parts[0] == "blocks":
            owner, leaf = parts[2:-1], parts[-1]
            is_ln = owner[-1].startswith("LayerNorm")
            key = "bias" if leaf == "bias" else ("scale" if is_ln else "kernel")
            val = a.t() if key == "kernel" else a
            stacks.setdefault(("blocks", *owner, key), {})[int(parts[1])] = (
                val.contiguous().numpy())
            continue
        owner, leaf = parts[0], parts[-1]
        key = kinds[owner] if leaf == "weight" else "bias"
        if key is None:
            key = "scale"
        val = a.t() if key == "kernel" else a
        _put(tree, (owner, key), val.contiguous().numpy().copy())
    for path, layers in stacks.items():
        _put(tree, path, np.stack([layers[i] for i in sorted(layers)]))
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
