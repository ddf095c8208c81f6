"""The CNN conv epilogue relu(+bias) -> 2x2 max-pool as Hopper kernels.

Counterpart of ``distributed_ml_pytorch_tpu/ops/fused_conv.py``
(``max_pool_2x2``, ``pool2_tiles``, ``relu_pool2``). The public functions
take NHWC tensors, as the JAX ones do. The port's models run their convs in
``torch.channels_last``, so a conv output's ``permute(0, 2, 3, 1)`` is a
contiguous NHWC view at no copy cost, and the pooled NHWC output permuted
back is channels_last again.

Numerics contract (the JAX module's, held by ``tests/test_torch_fused_conv.py``
and on the card by ``chip_smoke.py``):

- the forward is bit-identical to ``max_pool_2x2(relu(x + b))`` — the same
  adds and maxima;
- the backward routes each window's cotangent to the FIRST maximal element in
  window row-major order (torch's MaxPool2d tie rule) and applies relu's
  gradient-at-0 = 0, which together give ``where(m > 0, g, 0)`` at the
  first-max slot and zeros elsewhere — element-identical to the unfused chain.

On a CUDA tensor :func:`relu_pool2` runs the kernels of ``csrc/fused_conv.cu``
forward and backward (a ``torch.autograd.Function``); on a CPU tensor it runs
the plain versions. A CUDA input the kernel cannot take (not contiguous, not
float32) raises; nothing is copied silently.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from distributed_ml_pytorch_tpu_torch.ops import _build

#: launches of the forward and backward CUDA kernels (plain versions do not count)
launches = {"relu_pool2_fwd": 0, "relu_pool2_bwd": 0}


# ------------------------------------------------------------------ pooling

def _pool2_windows(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4, C), slots in window row-major order."""
    b, h, w, c = x.shape
    xw = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return xw.reshape(b, h // 2, w // 2, 4, c)


def _first_max_scatter(x: torch.Tensor, m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Each window's cotangent ``g`` to the first slot of ``x`` equal to its
    max ``m`` (window row-major order); zeros elsewhere. NHWC in and out."""
    b, h, w, c = x.shape
    xw = _pool2_windows(x)
    eq = xw == m.unsqueeze(3)
    first = eq & (torch.cumsum(eq.to(torch.int32), dim=3) == 1)
    scat = torch.where(first, g.unsqueeze(3), torch.zeros((), dtype=g.dtype, device=g.device))
    gx = scat.reshape(b, h // 2, w // 2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return gx.reshape(b, h, w, c)


class _MaxPool2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        m = _pool2_windows(x).amax(dim=3)
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        return _first_max_scatter(x, m, g)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool over NHWC with the first-max tie backward (plain
    PyTorch; the unfused chain's pool)."""
    if not pool2_tiles(x):
        raise ValueError(f"max_pool_2x2 needs rank-4 NHWC with even, nonzero "
                         f"spatial dims (got shape {tuple(x.shape)})")
    return _MaxPool2x2.apply(x)


def pool2_tiles(x) -> bool:
    """True when the relu+pool window view exists: rank-4 NHWC with even,
    nonzero dims (the pool's own requirement)."""
    return (
        getattr(x, "ndim", 0) == 4
        and x.shape[1] % 2 == 0
        and x.shape[2] % 2 == 0
        and all(d > 0 for d in x.shape)
    )


# ---------------------------------------------------- plain versions

def _relu(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z > 0, z, torch.zeros((), dtype=z.dtype, device=z.device))


def relu_pool2_fwd_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``max_pool_2x2(relu(x + b))`` as plain tensor operations."""
    z = x if bias is None else x + bias
    return _pool2_windows(_relu(z)).amax(dim=3)


def relu_pool2_bwd_plain(x: torch.Tensor, bias: Optional[torch.Tensor], m: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """The unfused chain's ``dz``: the pool's first-max scatter of ``g``, then
    relu's mask (gradient at 0 is 0)."""
    z = x if bias is None else x + bias
    dy = _first_max_scatter(_relu(z), m, g)
    return torch.where(z > 0, dy, torch.zeros((), dtype=dy.dtype, device=dy.device))


# ---------------------------------------------------- CUDA kernels

def _check_cuda(name: str, x: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} wants float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            f"{name} needs a contiguous NHWC tensor (a channels_last conv "
            f"output's permute(0, 2, 3, 1) is one); got strides {x.stride()}")
    if bias is not None and (
            bias.shape != (x.shape[-1],) or bias.dtype != torch.float32
            or not bias.is_contiguous() or bias.device != x.device):
        raise ValueError(f"{name}: bias must be a contiguous float32 ({x.shape[-1]},) "
                         f"vector on {x.device}")


def _fn(name: str, n_ptrs: int):
    fn = getattr(_build.load("fused_conv"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def relu_pool2_fwd_cuda(x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward kernel on a contiguous NHWC CUDA tensor."""
    _check_cuda("relu_pool2", x, bias)
    n, h, w, c = x.shape
    m = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    fn = _fn("dmt_relu_pool2_fwd_f32", 3)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), None if bias is None else bias.data_ptr(), m.data_ptr(),
                  n, h, w, c, _build.stream_of(x))
    _build.check(code, "relu_pool2 forward")
    launches["relu_pool2_fwd"] += 1
    return m


def relu_pool2_bwd_cuda(x: torch.Tensor, bias: Optional[torch.Tensor], m: torch.Tensor,
                        g: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel: ``dz`` at ``x``'s shape."""
    _check_cuda("relu_pool2 backward", x, bias)
    for name, t in (("m", m), ("g", g)):
        if t.shape != m.shape or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"relu_pool2 backward: {name} must be a contiguous "
                             f"float32 tensor of the pooled shape")
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    fn = _fn("dmt_relu_pool2_bwd_f32", 5)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), None if bias is None else bias.data_ptr(), m.data_ptr(),
                  g.data_ptr(), dx.data_ptr(), n, h, w, c, _build.stream_of(x))
    _build.check(code, "relu_pool2 backward")
    launches["relu_pool2_bwd"] += 1
    return dx


# ---------------------------------------------------- public op

class _ReluPool2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias):
        m = relu_pool2_fwd_cuda(x, bias) if x.is_cuda else relu_pool2_fwd_plain(x, bias)
        ctx.save_for_backward(x, bias, m)
        ctx.has_bias = bias is not None
        return m

    @staticmethod
    def backward(ctx, g):
        x, bias, m = ctx.saved_tensors
        if not ctx.has_bias:
            bias = None
        # the cotangent's layout is autograd's choice, not the caller's
        g = g.contiguous()
        if x.is_cuda:
            dz = relu_pool2_bwd_cuda(x, bias, m, g)
        else:
            dz = relu_pool2_bwd_plain(x, bias, m, g)
        db = None if bias is None else dz.sum(dim=(0, 1, 2))
        return dz, db


def relu_pool2(x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``max_pool_2x2(relu(x + bias))`` over NHWC as one kernel forward and
    one backward (the plain versions for a CPU tensor).

    ``bias`` broadcasts over the last axis (``None`` = pure relu). The domain
    is ``max_pool_2x2``'s: rank-4 NHWC with even, nonzero spatial dims
    (:func:`pool2_tiles`); other shapes raise ``ValueError``.
    """
    if not pool2_tiles(x):
        raise ValueError(
            f"relu_pool2 needs rank-4 NHWC with even, nonzero spatial dims "
            f"(got shape {tuple(getattr(x, 'shape', ()))}); no 2x2 stride-2 "
            f"pool is defined for this shape")
    return _ReluPool2.apply(x, bias)
