"""The CNN conv epilogues as Hopper kernels: relu(+bias) -> 2x2 max-pool
(K2) and the elementwise relu(+bias) (K3).

Counterpart of ``distributed_ml_pytorch_tpu/ops/fused_conv.py``
(``max_pool_2x2``, ``pool2_tiles``, ``relu_pool2``, ``bias_relu``). The public functions
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
forward and backward (a ``torch.autograd.Function``), in float32 or
bfloat16; on a CPU tensor it runs the plain versions. :func:`relu_pool2_route`
picks the kernels' route from the shape, dtype and pointers: 16-byte
accesses (4 float32 or 8 bfloat16 channels) when C is a multiple of that
width and every operand is 16-byte aligned (all of AlexNet's tails), scalar
ones otherwise; ``launches`` counts each dtype's routes apart (the
bfloat16 ones under ``.bf16`` keys). In bfloat16, ``x + bias`` is rounded to bfloat16
once, as the plain version rounds it, and the relu and the maxima are exact,
so both directions stay bit-identical. A CUDA input the kernels cannot take
(not contiguous, another dtype, a bias or cotangent of another dtype, 2^31
elements or more) raises; nothing is copied silently.

:func:`bias_relu` is ``relu(x + bias)`` over the last axis, forward and
backward bit-identical to the plain versions (the same add, rounded to the
input dtype, and the same compare; the gradient at 0 is 0). On a CUDA tensor
it runs the kernels of ``csrc/bias_relu.cu`` (float32 or bfloat16, any
shape, viewed as ``(R, C)`` rows); ``db`` is one sum over the leading axes
outside the kernel, as in JAX.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from distributed_ml_pytorch_tpu_torch.ops import _build

#: launches of the forward and backward CUDA kernels (plain versions do not
#: count); K2's also by dtype and route (float32's ``"relu_pool2_fwd.vector"``,
#: bfloat16's ``"relu_pool2_fwd.bf16.vector"`` and so on, see
#: :func:`relu_pool2_route`), which sum to its total over both dtypes
launches = {"relu_pool2_fwd": 0, "relu_pool2_bwd": 0, "bias_relu_fwd": 0, "bias_relu_bwd": 0,
            **{f"relu_pool2_{d}{dt}.{r}": 0 for d in ("fwd", "bwd") for dt in ("", ".bf16")
               for r in ("vector", "scalar")}}


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

#: the kernels index in 32 bits: tensors of this many elements or more raise
MAX_ELEMENTS = 2**31
#: K2's dtypes: the C entry points' suffix and the channels one 16-byte
#: access of the vector route holds
_POOL_DTYPES = {torch.float32: ("f32", 4), torch.bfloat16: ("bf16", 8)}


def relu_pool2_route(shape, dtype, data_ptrs) -> str:
    """K2's route for a contiguous NHWC ``shape`` whose operands start at
    ``data_ptrs``: ``"vector"`` (16 bytes a load: 4 float32 or 8 bfloat16
    channels) when C is a multiple of that width and every pointer is
    16-byte aligned, else ``"scalar"``. Raises for other dtypes than float32
    and bfloat16 and for ``MAX_ELEMENTS`` or more elements."""
    if dtype not in _POOL_DTYPES:
        raise TypeError(f"relu_pool2 wants float32 or bfloat16, got {dtype}")
    numel = 1
    for d in shape:
        numel *= d
    if numel >= MAX_ELEMENTS:
        raise ValueError(f"relu_pool2: {numel} elements; the kernels index in 32 bits "
                         f"(fewer than {MAX_ELEMENTS})")
    if shape[-1] % _POOL_DTYPES[dtype][1] == 0 and all(p % 16 == 0 for p in data_ptrs):
        return "vector"
    return "scalar"


def _check_cuda(name: str, x: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """What the kernels need beyond :func:`relu_pool2_route`'s dtype and
    size checks."""
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError(
            f"{name} needs a contiguous NHWC tensor (a channels_last conv "
            f"output's permute(0, 2, 3, 1) is one); got strides {x.stride()}")
    if bias is not None and (
            bias.shape != (x.shape[-1],) or bias.dtype != x.dtype
            or not bias.is_contiguous() or bias.device != x.device):
        raise ValueError(f"{name}: bias must be a contiguous {x.dtype} ({x.shape[-1]},) "
                         f"vector on {x.device}")


@functools.cache
def _fn(name: str, n_ptrs: int):
    """The C entry point ``name``, its argument types set once."""
    fn = getattr(_build.load("fused_conv"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(kernel: str, x: torch.Tensor, ptrs) -> str:
    """Launch ``dmt_<kernel>_<dtype>`` over ``x``'s shape on the route
    :func:`relu_pool2_route` picks from the operands' pointers ``ptrs`` (0
    for no bias); count it in total and by dtype and route."""
    route = relu_pool2_route(x.shape, x.dtype, [p for p in ptrs if p])
    suffix = _POOL_DTYPES[x.dtype][0]
    with torch.cuda.device(x.device):
        code = _fn(f"dmt_{kernel}_{suffix}", len(ptrs))(
            *ptrs, *x.shape, route == "vector", _build.stream_of(x))
    _build.check(code, f"{kernel} {suffix} ({route})")
    launches[kernel] += 1
    launches[f"{kernel}.bf16.{route}" if suffix == "bf16" else f"{kernel}.{route}"] += 1
    return route


def relu_pool2_fwd_cuda(x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward kernel on a contiguous NHWC CUDA tensor."""
    _check_cuda("relu_pool2", x, bias)
    n, h, w, c = x.shape
    m = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    _launch("relu_pool2_fwd", x,
            (x.data_ptr(), 0 if bias is None else bias.data_ptr(), m.data_ptr()))
    return m


def relu_pool2_bwd_cuda(x: torch.Tensor, bias: Optional[torch.Tensor], m: torch.Tensor,
                        g: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel: ``dz`` at ``x``'s shape."""
    if x.dim() != 4:
        raise ValueError(f"relu_pool2 backward: x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    pooled = (n, h // 2, w // 2, c)
    for name, t in (("m", m), ("g", g)):
        if (tuple(t.shape) != pooled or not t.is_contiguous() or t.dtype != x.dtype
                or t.device != x.device):
            raise ValueError(f"relu_pool2 backward: {name} must be a contiguous {x.dtype} "
                             f"tensor of the pooled shape {pooled} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    _check_cuda("relu_pool2 backward", x, bias)
    dx = torch.empty_like(x)
    _launch("relu_pool2_bwd", x,
            (x.data_ptr(), 0 if bias is None else bias.data_ptr(), m.data_ptr(),
             g.data_ptr(), dx.data_ptr()))
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


# ------------------------------------------------- relu(+bias) epilogue (K3)

_BIAS_RELU_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bias_relu_fwd_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(x + bias)`` as plain tensor operations (``bias=None``: relu)."""
    return _relu(x if bias is None else x + bias)


def bias_relu_bwd_plain(x: torch.Tensor, bias: Optional[torch.Tensor],
                        g: torch.Tensor) -> torch.Tensor:
    """``dz = where(x + bias > 0, g, 0)``: relu's gradient, 0 at 0."""
    z = x if bias is None else x + bias
    return torch.where(z > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))


def _check_bias_relu_cuda(name: str, x: torch.Tensor, bias: Optional[torch.Tensor],
                          g: Optional[torch.Tensor] = None) -> int:
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if x.dtype not in _BIAS_RELU_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    for label, t, shape in (("x", x, x.shape), ("bias", bias, (_channels(x),)),
                            ("g", g, x.shape)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous; got strides {t.stride()}")
        if t.shape != shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: {label} must be a {x.dtype} {tuple(shape)} tensor on "
                             f"{x.device}")
    return _BIAS_RELU_DTYPES[x.dtype]


def _channels(x: torch.Tensor) -> int:
    """C of the (R, C) row view."""
    return x.shape[-1] if x.dim() else 1


@functools.cache
def _bias_relu_fn(name: str, n_ptrs: int):
    """The C entry point ``name``, its argument types set once."""
    fn = getattr(_build.load("bias_relu"), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bias_relu_fwd_cuda(x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3a on a contiguous CUDA tensor: ``relu(x + bias)``."""
    code = _check_bias_relu_cuda("bias_relu", x, bias)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _bias_relu_fn("dmt_bias_relu_fwd", 3)(
            x.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
            x.numel(), _channels(x), code, _build.stream_of(x))
    _build.check(rc, "bias_relu forward")
    launches["bias_relu_fwd"] += 1
    return y


def bias_relu_bwd_cuda(x: torch.Tensor, bias: Optional[torch.Tensor],
                       g: torch.Tensor) -> torch.Tensor:
    """Launch K3b: ``dz = where(x + bias > 0, g, 0)`` at ``x``'s shape."""
    code = _check_bias_relu_cuda("bias_relu backward", x, bias, g)
    dz = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _bias_relu_fn("dmt_bias_relu_bwd", 4)(
            x.data_ptr(), None if bias is None else bias.data_ptr(), g.data_ptr(),
            dz.data_ptr(), x.numel(), _channels(x), code, _build.stream_of(x))
    _build.check(rc, "bias_relu backward")
    launches["bias_relu_bwd"] += 1
    return dz


class _BiasRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias):
        y = bias_relu_fwd_cuda(x, bias) if x.is_cuda else bias_relu_fwd_plain(x, bias)
        ctx.save_for_backward(x, bias)
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        if not ctx.has_bias:
            bias = None
        g = g.contiguous()
        dz = bias_relu_bwd_cuda(x, bias, g) if x.is_cuda else bias_relu_bwd_plain(x, bias, g)
        db = None
        if bias is not None and ctx.needs_input_grad[1]:
            db = dz.sum(dim=tuple(range(dz.dim() - 1))).reshape(bias.shape)
        return dz, db


def bias_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(x + bias)`` as one kernel forward and one backward (the plain
    versions for a CPU tensor).

    ``bias`` broadcasts over the last axis (``None`` = pure relu). The
    backward computes ``dz = where(x + bias > 0, g, 0)`` in one kernel and
    reduces ``db`` outside it (one sum over the leading axes).
    """
    return _BiasRelu.apply(x, bias)
