"""The restructured lm_head SGD step and its fused head update (K7).

Counterpart of ``distributed_ml_pytorch_tpu/ops/fused_head.py``. The LM
train step that ``bench_all.bench_lm`` measures for every model with a
detachable head is :func:`make_fused_head_sgd_step`: the body runs forward
under autograd, the head's cross-entropy is written out by hand so that one
logsumexp serves the loss, the hidden states' gradient and the head's
update, and the head's weight is updated by :func:`head_update_sgd` (plain
SGD) without autograd ever forming its gradient.

:func:`head_update_sgd` computes ``W − lr · dlᵀ·h`` with ``dl =
(softmax(logits) − onehot(labels)) · gscale``:

- ``use_kernel=False`` (the default, as in JAX) is the formulation the JAX
  module leaves to XLA: ``dl`` materialized elementwise in float32 and
  rounded to the activation dtype, then one matrix product accumulated in
  float32 (``torch.mm`` with ``out_dtype`` on the card), then the update:
  :func:`head_update_plain`, copied into ``W``.
- ``use_kernel=True`` on CUDA tensors launches K7 (``csrc/fused_head.cu``),
  which never writes ``dl`` to memory, at any N, V and D, by one of three
  routes that :func:`head_update_route` picks from the dtype, the shapes
  and the alignment: ``"bf16_tma"`` (TMA and wgmma, bfloat16 with V and D
  multiples of 8 and 16-byte aligned ``h2`` and ``logits``), ``"bf16"``
  (element loads, any other bfloat16 shape) and ``"f32"``. A launch that
  fails raises; nothing falls back to another route. On CPU tensors it runs
  the plain version, as every op of the port does. The JAX module's
  warn-and-fall-back branch (its kernel needed N % 1024 == 0) has no
  counterpart.

Layout: the port's ``lm_head.weight`` is float32 ``(V, D)`` (``nn.Linear``'s
layout); the JAX ``W`` is ``(D, V)``. Every function here takes the port's
layout; the parity tests transpose at the seam. ``W`` is updated in place
(the JAX kernel aliases it too when the state is donated). The JAX module's
``BLOCK_N`` / ``BLOCK_V`` are the TPU kernel's tile sizes and its
divisibility rule; the card's tiles live in the CUDA source and gate nothing,
so the names are not carried over.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.ops import _build

#: launches of K7 (the plain version does not count)
launches = 0
#: launches of K7 by route (they sum to ``launches``)
route_launches = {"f32": 0, "bf16": 0, "bf16_tma": 0}

#: the route codes of ``dmt_head_update``
_ROUTE_CODES = {"f32": 0, "bf16": 1, "bf16_tma": 2}
#: vocabulary rows per thread block of each route and the most blocks the
#: grid axis they lie on takes (csrc/fused_head.cu: kSV and kBV on the
#: grid's y axis, kTV on its x axis)
_VOCAB_TILE = {"f32": (64, 65535), "bf16": (128, 65535), "bf16_tma": (64, 2 ** 31 - 1)}
_INT32_MAX = 2 ** 31 - 1


# ------------------------------------------------------------------ plain version

def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in float32 (the JAX
    ``preferred_element_type=float32``). Products of two bfloat16 values are
    exact in float32, so upcasting first computes the same function; on the
    card ``out_dtype`` lets cuBLAS do it without the float32 copies."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def head_dlogits(h2, logits, lse, labels, gscale) -> torch.Tensor:
    """``dl = ((exp(logits − lse) − onehot(labels)) · gscale)`` rounded to
    ``h2.dtype``, ``(N, V)``. ``p − onehot`` is taken in place at the label
    columns only (subtracting 0 elsewhere is exact), so float32 ``p`` is the
    one full-size temporary. ``labels`` must lie in ``[0, V)``."""
    p = torch.exp(logits.float() - lse[:, None])
    p[torch.arange(p.shape[0], device=p.device), labels.long()] -= 1.0
    p *= gscale[:, None]
    return p.to(h2.dtype)


def head_update_plain(W, h2, logits, lse, labels, gscale, lr: float) -> torch.Tensor:
    """The JAX module's XLA formulation (fused_head.py:182-187) in the port's
    ``(V, D)`` layout: ``W − lr · dlᵀ·h2`` with ``dlᵀ·h2`` accumulated in
    float32. Returns a new tensor."""
    return W - lr * _mm_f32(head_dlogits(h2, logits, lse, labels, gscale).t(), h2)


# ------------------------------------------------------------------ CUDA kernel

def head_update_route(h2: torch.Tensor, logits: torch.Tensor) -> str:
    """K7's route for these inputs: ``"f32"`` for float32; for bfloat16,
    ``"bf16_tma"`` when TMA can read both matrices (V and D multiples of 8,
    so that their rows are whole 16-byte units, and ``h2`` and ``logits``
    starting on 16-byte boundaries), else ``"bf16"``. Shapes, dtype and
    addresses only: the CPU tests call it on CPU tensors."""
    if h2.dtype == torch.float32:
        return "f32"
    d, v = h2.shape[1], logits.shape[1]
    aligned = h2.data_ptr() % 16 == 0 and logits.data_ptr() % 16 == 0
    return "bf16_tma" if v % 8 == 0 and d % 8 == 0 and aligned else "bf16"


def _check_cuda(W, h2, logits, lse, labels, gscale) -> str:
    n, d = h2.shape
    v = logits.shape[1]
    for name, t in (("W", W), ("h2", h2), ("logits", logits), ("lse", lse),
                    ("labels", labels), ("gscale", gscale)):
        if not t.is_cuda or t.device != W.device:
            raise ValueError(f"head_update: {name} must be a CUDA tensor on {W.device}")
        if not t.is_contiguous():
            raise ValueError(f"head_update: {name} must be contiguous; got strides {t.stride()}")
    if W.dtype != torch.float32 or W.shape != (v, d):
        raise TypeError(f"head_update: W must be float32 ({v}, {d}), got {W.dtype} "
                        f"{tuple(W.shape)}")
    if h2.dtype not in (torch.float32, torch.bfloat16) or logits.dtype != h2.dtype:
        raise TypeError(f"head_update: h2 and logits must share float32 or bfloat16, got "
                        f"{h2.dtype} and {logits.dtype}")
    if logits.shape[0] != n or any(t.shape != (n,) for t in (lse, labels, gscale)):
        raise ValueError(f"head_update: logits ({n}, V), lse, labels and gscale ({n},) "
                         f"expected for h2 ({n}, {d})")
    if lse.dtype != torch.float32 or gscale.dtype != torch.float32:
        raise TypeError("head_update: lse and gscale must be float32")
    if labels.dtype != torch.int64:
        raise TypeError(f"head_update: labels must be int64, got {labels.dtype}")
    if max(n, d, v) > _INT32_MAX:
        raise ValueError(f"head_update: N, D and V must fit in int32, got {n}, {d}, {v}")
    route = head_update_route(h2, logits)
    _check_vocab(v, route)
    return route


def _check_vocab(v: int, route: str) -> None:
    tile, most = _VOCAB_TILE[route]
    if -(-v // tile) > most:
        raise ValueError(f"head_update: vocabulary {v} exceeds the {route} kernel's grid "
                         f"({most} blocks of {tile} rows)")


def head_update_cuda(W, h2, logits, lse, labels, gscale, alpha: float) -> torch.Tensor:
    """Launch K7: ``W += alpha · dlᵀ·h2`` in place (``alpha = −lr``), by the
    route :func:`head_update_route` picks."""
    global launches
    route = _check_cuda(W, h2, logits, lse, labels, gscale)
    fn = _build.load("fused_head").dmt_head_update
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, d = h2.shape
    with torch.cuda.device(W.device):
        rc = fn(W.data_ptr(), h2.data_ptr(), logits.data_ptr(), lse.data_ptr(),
                labels.data_ptr(), gscale.data_ptr(), float(alpha), n, d, logits.shape[1],
                _ROUTE_CODES[route], _build.stream_of(W))
    _build.check(rc, f"head_update ({route})")
    launches += 1
    route_launches[route] += 1
    return W


def head_update_sgd(W, h2, logits, lse, labels, gscale, lr: float,
                    use_kernel: bool = False) -> torch.Tensor:
    """``W − lr · hᵀ·dlogits`` without forming the head's gradient in
    autograd, applied to ``W`` in place and returned.

    ``W`` ``(V, D)`` float32; ``h2`` ``(N, D)`` activations; ``logits``
    ``(N, V)`` as the forward produced them (``h2 @ W.T`` in ``h2.dtype``);
    ``lse`` ``(N,)`` float32 log-sum-exp of each logits row; ``labels``
    ``(N,)`` int64; ``gscale`` ``(N,)`` float32 = ∂loss/∂ce per row (the
    loss mask over its sum). ``use_kernel`` selects K7 on CUDA tensors (see
    the module docstring); the default is the plain formulation.
    """
    if use_kernel and W.is_cuda:
        return head_update_cuda(W, h2, logits, lse, labels, gscale, -lr)
    return W.copy_(head_update_plain(W, h2, logits, lse, labels, gscale, lr))


# ------------------------------------------------------------------ the train step

def make_fused_head_sgd_step(model: nn.Module, lr: float, use_kernel: bool = False) -> Callable:
    """``step(state, tokens, targets) -> (state, loss)``: one plain-SGD LM
    step with the restructured lm_head (JAX fused_head.py:190-253).

    Same function as the AD step over ``parallel/fsdp.lm_loss_builder`` and
    SGD at ``lr`` (tested): the loss is the masked-mean next-token CE with
    the final position masked. Order, so that every gradient comes from the
    old parameters:

    1. the body forward (``model.hidden``) under autograd;
    2. the head CE by hand on ``h2 = hidden.reshape(b·s, d)`` (a detached
       leaf): logits in the activation dtype, ``lse`` of their float32 copy,
       the label logit, a float32 mask with the final position 0;
    3. ``dh2 = ∂loss/∂h2`` by autograd, before the head's weight changes;
    4. :func:`head_update_sgd` on ``lm_head.weight`` in place (``use_kernel``
       selects K7), reading the logits and lse of step 2;
    5. ``hidden.backward(dh2)`` and plain SGD on the body parameters.

    Plain SGD only, as in JAX: fusing the update into the backward is sound
    only when the update needs nothing but the gradient itself.
    """
    if getattr(model, "head", None) is not True or not hasattr(model, "lm_head"):
        raise ValueError("make_fused_head_sgd_step needs a model with a detachable lm_head "
                         "(TransformerLM with head=True)")
    W = model.lm_head.weight
    body = [p for name, p in model.named_parameters() if name != "lm_head.weight"]

    def step(state, tokens: torch.Tensor, targets: torch.Tensor):
        model.train()
        for p in body:
            p.grad = None
        b, s = tokens.shape
        hidden = model.hidden(tokens)
        h2 = hidden.detach().reshape(b * s, hidden.shape[-1]).requires_grad_(True)
        labels = targets.reshape(-1).long()
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
        mask[:, -1] = 0.0
        mask = mask.reshape(-1)
        gscale = mask / torch.sum(mask)

        logits = F.linear(h2, W.detach().to(h2.dtype))
        lse = torch.logsumexp(logits.float(), dim=-1)
        label_logit = logits.gather(1, labels[:, None])[:, 0].float()
        loss = torch.sum((lse - label_logit) * mask) / torch.sum(mask)
        (dh2,) = torch.autograd.grad(loss, h2)
        with torch.no_grad():
            head_update_sgd(W, h2.detach(), logits.detach(), lse.detach(), labels, gscale,
                            lr, use_kernel=use_kernel)
        del logits, lse  # 2 bytes per logit at bf16, freed before the body's backward
        hidden.backward(dh2.reshape(hidden.shape))
        with torch.no_grad():
            for p in body:
                if p.grad is not None:  # a parameter the loss does not reach stays
                    p.add_(p.grad * (-lr))
        state.step += 1
        return state, loss.detach()

    return step
