"""Hand-written Hopper kernels for the port's hot ops, each beside its plain
PyTorch version.

- ``fused_update``: the DownPour flat accumulator ``flat_axpy`` (K1).
- ``fused_conv``: the AlexNet conv epilogue ``relu_pool2`` forward and
  backward (K2), and the plain first-max ``max_pool_2x2``.

The CUDA sources live in ``csrc/`` and are built by ``_build`` at first use.
"""

from distributed_ml_pytorch_tpu_torch.ops.fused_conv import (
    max_pool_2x2,
    pool2_tiles,
    relu_pool2,
)
from distributed_ml_pytorch_tpu_torch.ops.fused_update import (
    LANES,
    downpour_accumulate,
    flat_axpy,
)

__all__ = [
    "LANES",
    "flat_axpy",
    "downpour_accumulate",
    "max_pool_2x2",
    "pool2_tiles",
    "relu_pool2",
]
