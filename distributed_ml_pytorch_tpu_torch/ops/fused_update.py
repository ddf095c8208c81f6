"""The flat-parameter axpy — the DownPour hot op — as a Hopper kernel.

Counterpart of ``distributed_ml_pytorch_tpu/ops/fused_update.py``. The worker
accumulates its updates into a flat float32 vector on every step:
``y + alpha * x`` over the whole raveled model, bandwidth-bound on any
hardware. On a CUDA tensor :func:`flat_axpy` launches the kernel of
``csrc/fused_update.cu`` (float4 grid-stride, any length, bit-identical to
the plain version for every ``alpha``); on a CPU tensor it runs the plain
PyTorch version, :func:`flat_axpy_plain`. There is no other path: a CUDA
tensor the kernel cannot take raises.

Both update ``y`` in place and return it — the TPU kernel aliases its output
onto ``y``'s buffer, and this is the one in-place update of an input that the
port makes.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_ml_pytorch_tpu_torch.ops import _build

#: the accumulator is padded to a multiple of this many elements, so the flat
#: vector has the same length on both packages (the TPU kernel's lane width)
LANES = 128

#: launches of the CUDA kernel (the plain version does not count)
launches = 0


def flat_axpy_plain(y: torch.Tensor, x: torch.Tensor, alpha: float) -> torch.Tensor:
    """``y += alpha * x`` as two tensor operations (two roundings)."""
    return y.add_(x * alpha)


def _check(y: torch.Tensor, x: torch.Tensor) -> None:
    if y.dim() != 1 or y.shape != x.shape:
        raise ValueError(
            f"flat_axpy wants equal 1-D shapes, got {tuple(y.shape)} / {tuple(x.shape)}")
    if y.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"flat_axpy wants float32, got {y.dtype} / {x.dtype}")
    if y.device != x.device:
        raise ValueError(f"flat_axpy operands on {y.device} and {x.device}")


def flat_axpy_cuda(y: torch.Tensor, x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Launch the CUDA kernel: ``y += alpha * x`` in place on the card."""
    global launches
    _check(y, x)
    if not y.is_cuda:
        raise ValueError("flat_axpy_cuda needs CUDA tensors")
    if not (y.is_contiguous() and x.is_contiguous()):
        raise ValueError("flat_axpy_cuda needs contiguous vectors")
    lib = _build.load("fused_update")
    fn = lib.dmt_flat_axpy_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(y.device):
        code = fn(y.data_ptr(), x.data_ptr(), float(alpha), y.numel(),
                  _build.stream_of(y))
    _build.check(code, "flat_axpy")
    launches += 1
    return y


def flat_axpy(y: torch.Tensor, x: torch.Tensor, alpha) -> torch.Tensor:
    """``y + alpha * x`` over flat float32 vectors, written into ``y``.

    The CUDA kernel for tensors on the card, the plain version for tensors
    on the CPU. Any length; ``alpha`` is a Python number (rounded to
    float32, as the TPU kernel's SMEM scalar is).
    """
    _check(y, x)
    if y.is_cuda:
        return flat_axpy_cuda(y, x, alpha)
    return flat_axpy_plain(y, x, float(alpha))


def downpour_accumulate(accum: torch.Tensor, flat_grads: torch.Tensor, lr) -> torch.Tensor:
    """``accum - lr * grads`` — the reference's ``accum.add_(-lr, grads)``
    (``Asynchronous.py:55``), in place on ``accum``."""
    return flat_axpy(accum, flat_grads, -lr)
