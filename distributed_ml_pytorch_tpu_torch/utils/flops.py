"""Analytic FLOPs of an LM train step and the card's peak (counterpart of
the JAX ``utils/flops.py``'s ``flash_attention_train_flops`` and
``lm_train_flops_6nd``).

The peak table is keyed by ``torch.cuda.get_device_name()``: the H100 SXM5's
dense bf16 tensor-core rate, 989.4 TFLOP/s, from NVIDIA's H100 data sheet.
MFU is achieved FLOP/s over that bf16 peak whatever the dtype, with the
dtype stated beside it.
"""

from __future__ import annotations

from typing import Optional

#: dense peak FLOP/s by CUDA device name (NVIDIA's H100 data sheet, SXM5)
PEAK_FLOPS: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12},
}


def device_peak_flops(name: str, dtype: str = "bf16") -> Optional[float]:
    """Peak FLOP/s of the card named ``name`` at ``dtype``, or None when the
    table has no entry."""
    return PEAK_FLOPS.get(name, {}).get(dtype)


def flash_attention_train_flops(batch: int, heads: int, seq: int,
                                head_dim: int, n_layers: int, *,
                                causal: bool = True,
                                remat: bool = False,
                                bwd_impl: str = "fused") -> float:
    """FLOPs of the flash-attention kernels for one train step: the forward
    does 2 products over the S² score plane (QKᵀ, PV); the fused backward 5
    (recomputed S, dV, dP, dK, dQ) → 7 in all; the split backward 3 in the
    dQ kernel + 4 in the dK/dV kernel → 9. ×2 FLOPs per MAC, halved for
    causal (dead blocks are skipped). Per-block remat reruns the forward
    (+2)."""
    matmuls = (7 if bwd_impl == "fused" else 9) + (2 if remat else 0)
    per_layer = matmuls * 2 * batch * heads * seq * seq * head_dim
    if causal:
        per_layer /= 2
    return float(per_layer * n_layers)


def lm_train_flops_6nd(n_matmul_params: float, batch: int, seq: int,
                       heads: int, head_dim: int, n_layers: int, *,
                       causal: bool = True, remat: bool = False,
                       bwd_impl: str = "fused") -> float:
    """``6·N·D`` over the dense-matmul parameters (embedding tables excluded,
    the lm_head included) plus the attention S² term; remat adds 2·N·D."""
    dense_factor = 6.0 + (2.0 if remat else 0.0)
    dense = dense_factor * float(n_matmul_params) * batch * seq
    attn = flash_attention_train_flops(
        batch, heads, seq, head_dim, n_layers,
        causal=causal, remat=remat, bwd_impl=bwd_impl)
    return dense + attn
