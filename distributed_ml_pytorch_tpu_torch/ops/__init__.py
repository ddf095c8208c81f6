"""Hand-written Hopper kernels for the port's hot ops, each beside its plain
PyTorch version.

- ``fused_update``: the DownPour flat accumulator ``flat_axpy`` (K1).
- ``fused_conv``: the AlexNet conv epilogue ``relu_pool2`` forward and
  backward (K2), and the plain first-max ``max_pool_2x2``.
- ``attention``: flash attention forward (K4), fused backward (K5) and split
  backward (K6a dQ, K6b dK/dV), the blockwise scan and ``auto_attention``.

The CUDA sources live in ``csrc/`` and are built by ``_build`` at first use.
"""

from distributed_ml_pytorch_tpu_torch.ops.attention import (
    attention_reference,
    auto_attention,
    blockwise_attention,
    finalize_attention,
    flash_attention,
    flash_attention_lse,
    scan_attn_fn,
)
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
    "attention_reference",
    "auto_attention",
    "blockwise_attention",
    "finalize_attention",
    "flash_attention",
    "flash_attention_lse",
    "scan_attn_fn",
    "flat_axpy",
    "downpour_accumulate",
    "max_pool_2x2",
    "pool2_tiles",
    "relu_pool2",
]
