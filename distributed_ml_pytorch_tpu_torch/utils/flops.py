"""Analytic FLOPs of an LM or CNN train step, the card's peak and the
utilization they give (counterpart of the JAX ``utils/flops.py``'s
``flash_attention_train_flops``, ``lm_train_flops_6nd``,
``check_flops_agreement`` and ``utilization``; XLA's ``compiled_flops`` has no
counterpart in PyTorch).

The peak table is keyed by ``torch.cuda.get_device_name()``, from NVIDIA's
H100 data sheet (SXM5): the dense bf16 tensor-core rate, 989.4 TFLOP/s, and
the float32 rate outside the tensor cores, 67 TFLOP/s. MFU is achieved
FLOP/s over the bf16 peak unless a caller names another dtype, with the
dtype stated beside it.
"""

from __future__ import annotations

from typing import Optional

#: dense peak FLOP/s by CUDA device name (NVIDIA's H100 data sheet, SXM5)
PEAK_FLOPS: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "f32": 67e12},
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


def moe_lm_train_flops(batch: int, seq: int, vocab: int, d_model: int, n_heads: int,
                       n_layers: int, d_ff: int, n_experts: int, capacity: int,
                       *, remat: bool = False) -> float:
    """FLOPs of one ``MoETransformerLM`` train step counted over the
    products it runs, not 6·N·D over every expert's parameters: per layer
    the q/k/v/o projections, the router, the dispatch einsum (``[B,S,E,C] x
    [B,S,D]``), the stacked expert products over all E·B·C slots, the
    combine einsum and the attention S² term; then the lm_head. A product
    costs its forward and, in the backward, both operand gradients (3x),
    except the dispatch, whose one-hot operand takes no gradient (2x).
    Remat reruns the forwards (+1x)."""
    t = batch * seq
    fwd = 1.0 if remat else 0.0
    dense = 2.0 * t * d_model * (4 * d_model + n_experts)             # q, k, v, o, router
    experts = 2.0 * 2 * n_experts * batch * capacity * d_model * d_ff  # up and down
    route = 2.0 * batch * seq * n_experts * capacity * d_model         # one einsum
    per_layer = ((3 + fwd) * (dense + experts + route) + (2 + fwd) * route)
    head = (3 + fwd) * 2.0 * t * d_model * vocab
    attn = flash_attention_train_flops(batch, n_heads, seq, d_model // n_heads, n_layers,
                                       causal=True, remat=remat)
    return per_layer * n_layers + head + attn


def check_flops_agreement(hybrid: Optional[float], analytic: float,
                          tol: float = 0.15) -> Optional[str]:
    """None when two FLOP counts of one step agree within ``tol``; otherwise
    a warning string for the bench log."""
    if not hybrid or analytic <= 0:
        return None
    rel = abs(hybrid - analytic) / analytic
    if rel <= tol:
        return None
    return (f"FLOPs cross-check FAILED: hybrid numerator {hybrid:.3e} vs "
            f"analytic 6ND {analytic:.3e} ({100 * rel:.0f}% apart > "
            f"{100 * tol:.0f}%) — audit utils/flops.py before trusting MFU")


def conv_linear_macs(model, input_shape) -> dict[str, int]:
    """Multiply-accumulates per forward of each ``nn.Conv2d`` and
    ``nn.Linear`` of ``model`` (by module name), from the output shapes of
    one forward at ``input_shape``: outputs x (in channels / groups) x the
    kernel's area for a conv, outputs x in features for a linear layer.
    ``input_shape``'s leading axis is the batch the counts are for."""
    import torch
    import torch.nn as nn

    macs: dict[str, int] = {}

    def hook(name):
        def record(mod, _inp, out):
            if isinstance(mod, nn.Conv2d):
                per_out = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
            else:
                per_out = mod.in_features
            macs[name] = out.numel() * per_out
        return record

    handles = [mod.register_forward_hook(hook(name)) for name, mod in model.named_modules()
               if isinstance(mod, (nn.Conv2d, nn.Linear))]
    try:
        dev = next(model.parameters()).device
        with torch.no_grad():
            model(torch.zeros(input_shape, device=dev))
    finally:
        for h in handles:
            h.remove()
    return macs


def cnn_train_flops(macs_per_image: float, batch: int) -> float:
    """FLOPs of one train step: 2 per MAC, forward plus a backward of twice
    the forward's work (dgrad and wgrad), over ``batch`` images."""
    return 2.0 * 3.0 * float(macs_per_image) * batch


def utilization(flops_per_step: Optional[float], step_seconds: float,
                device: Optional[str] = None,
                dtype: str = "bf16") -> tuple[Optional[float], Optional[float]]:
    """(achieved TFLOP/s, MFU fraction vs the ``dtype`` peak) for a measured
    step time; either element is None when its ingredient is unavailable.
    ``device`` is a CUDA device name (default: the first card's, when there
    is one); a name without a peak entry, such as ``"cpu"``, gives no MFU."""
    if not flops_per_step or step_seconds <= 0:
        return None, None
    if device is None:
        import torch

        device = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    achieved = flops_per_step / step_seconds
    peak = device_peak_flops(device, dtype)
    return achieved / 1e12, (achieved / peak if peak else None)
