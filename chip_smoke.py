#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device and build: the card's name, count and power limit, and the nvcc
   build of ``distributed_ml_pytorch_tpu_torch/csrc/*.cu``; then the
   ``-Xptxas -v`` lines (registers, spills) of the tensor-core K4, of K5,
   K6a and K6b, and of K8, each source on a line of its own;
2. every kernel against its plain PyTorch version on the card, at the shapes
   of the main path (flat_axpy at AlexNet's padded length; relu_pool2
   forward and backward at AlexNet's three epilogue shapes at batch 64,
   ties included), bit-identical; with the kernel's, the plain version's and
   one library call's time (CUDA events, the launches queued behind a busy
   wait so the card runs them back to back) and the byte bound at 3.35 TB/s;
3. trainer steps of AlexNet(fused_epilogue=True) against the same steps of
   fused_epilogue=False (cuDNN deterministic, full float32): equal losses
   and parameters;
4. the DownPour path: a parameter server and two workers in one process
   (threads, in-process transport) through ``run_server``/``train_worker``
   with the CLI defaults (AlexNet, batch 64, lr 0.008, n_push = n_pull = 10)
   on synthetic CIFAR-10; the kernels' launch counts are zeroed just before
   and read just after, and every kernel must have run;
5. the flash-attention kernels (K4 forward, K5 fused backward, K6a split
   dQ and K6b split dK/dV: the tensor-core kernels for bfloat16, the scalar
   ones for float32) against their plain versions on the same inputs, K6b's
   dK and dV also bit for bit against K5's and K6a's dQ bit for bit between
   two launches, at small shapes (float32 causal and not, head_dim 16 in
   both dtypes and bfloat16 non-causal, 32 and 128 in bfloat16, a ragged s
   200, 100 queries over 300 keys), at the LM's per-layer shape (b8 h12
   s2048 d64, bfloat16, causal: a 32-tile key loop) and at one long shape
   (b1 h2 s16384 d64, bfloat16, causal: a 256-tile key loop, the plain
   versions over the whole score plane), within the stated tolerances;
   timed at the LM shape beside the plain versions,
   ``F.scaled_dot_product_attention`` (the pair K6a + K6b beside its
   backward) and the FLOP bound at 989.4 TFLOP/s;
6. the LM path: ``training.train_lm`` with GPT-2-small (vocab 50304, d 768,
   12 heads, 12 layers, d_ff 3072, bfloat16, RoPE, batch 8 x seq 2048) for
   ``LM_STEPS`` steps on one repeated batch, the attention launch counts
   zeroed just before and read just after (K4 and K5 12 per step, K6 none);
   the loss must fall and every parameter stay finite; then one step from
   the trained weights with the default (fused) backward and one with
   ``bwd_impl="split"`` injected, which must agree; the profiled step's
   "K4 flash_fwd" and "K5 flash_bwd_fused" groups must read the tensor-core
   kernels, and the scalar K5 must not run; the fused and the split step
   timed (one warm-up, three steps, ``utils/devtime``) and one split step
   profiled, whose "K6a flash_bwd_dq" and "K6b flash_bwd_dkv" groups must
   show the tensor-core K6a and K6b 12 times each and no scalar one (a
   profile that records no kernel fails the phase); then
   ``train_lm`` and the serving demo with their default widths (8 heads of
   d_model 128: head_dim 16), launching K4/K5 and K8;
7. the decode-attention kernel (K8) against its reference on the same
   inputs: b32 h12 d64 T16 at C 128, 256 and 383 with per-row t (0, 5, 15)
   and ring_base, through strided live-prefix views, at C 8192, with
   bfloat16 and int8 caches, and float32 at a small shape, within the stated
   bounds; then with the keys split over 1, 2, 4 and 8 blocks, forced, on
   the same inputs (rows with no live key among them), each within the bound
   of the reference and of one block; timed cold (input sets in turn, twice
   the L2) beside the reference, ``F.scaled_dot_product_attention`` over a
   pre-concatenated K/V, and the byte bound, at the decode shape and at b1
   with 2,048 live keys and b8 with 256 (each also at every split count);
8. ``generate()`` on GPT-2-small (vocab 50304, d 768, 12 heads, 12 layers,
   d_ff 3072, bfloat16, learned positions, max_len 384) at batch 32, prompt
   128, 256 new tokens, greedy, the blocked path — once with the bfloat16
   cache and once with ``kv_quant``: tokens/s, ms per decode step, the byte
   roofline share, peak memory, one profiled decode step; K8 launched 12
   times per padded step and the reference never; the first two blocks
   teacher-forced through K8 and through the reference must agree;
9. the serving engine at the same width through the in-process frontend (8
   slots, cache 512, decode block 16, prefill bucket 16): 16 requests,
   prompts of 16-128 tokens, 32-128 new tokens, odd ones sampled (0.8, top-k
   40, top-p 0.95); every stream complete and in vocabulary; TTFT/TPOT
   percentiles, occupancy, K8 launches and the split count of each; the
   engine must pass K8 a live-prefix view, not its 512-row allocation; K8 on
   the engine's own inputs at its longest cache, at every split count,
   within the bound of the reference and timed cold;
10. the conv-epilogue ladder: the bias+relu kernels (K3a forward, K3b
   backward) bit-identical to their plain versions, with and without bias,
   at (4096, 384), at AlexNet's NHWC tail (256, 4, 4, 384), at an odd C
   (1000, 37) and in bfloat16; timed cold beside the plain versions, one
   library call and the byte bound; then ``bench_all.compute_microbench_phase`` (fused
   against unfused ``relu_pool2`` and ``bias_relu`` at batch 256), the K3
   launch counts zeroed just before and read just after;
11. the fused head update (K7) against ``head_update_plain`` on the same
   inputs at GPT-2-small b8 x 2048 (bf16 h2 and logits from a real h2 @ W
   product, float32 lse, random labels, gscale = mask / sum(mask)) and at a
   ragged N 1000, D 64, V 677 (float32, bfloat16) and V 680 (bfloat16), from
   W = 0 and from W, within ``HEAD_TOL``; timed beside the plain version
   (the default formulation), the product alone and the FLOP bound, with
   peak memory;
12. the restructured-head GPT-2-small step: ``bench_all.lm_phase`` (config
   6's three legs: tokens/s and MFU), then one step each of
   ``make_fused_head_sgd_step`` with ``use_kernel`` False and True and of the
   AD step ``make_fsdp_lm_train_step`` from the same weights: K7 once per
   ``use_kernel=True`` step and never otherwise, K4 and K5 12 times each;
   equal losses between the two fused steps and updates within
   ``FUSED_HEAD_UPDATE_TOL``; the AD step within ``AD_LOSS_TOL`` and
   ``AD_UPDATE_TOL``; step ms and peak memory of the three, and one
   profiled ``use_kernel=True`` step.

Then the ``kernels`` line, the ``nvidia-smi`` name/power line, and last the
result line ``{"ok": true, "device": {...}}``. Without a card, or without
the package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
BF16_FLOPS = 989.4e12      # H100 SXM dense bf16 tensor cores, NVIDIA's data sheet
L2_BYTES = 50 * 2**20      # H100 L2 cache
ALEXNET_PADDED = 2_472_320
POOL_SHAPES = [(64, 8, 8, 64), (64, 4, 4, 192), (64, 2, 2, 256)]
WORKER_STEPS = 80
ATTN_MAIN = (8, 12, 2048, 64)  # GPT-2-small's per-layer attention shape
#: one long causal case: a 256-tile key loop (ATTN_MAIN's is 32 tiles); the
#: plain versions hold its whole (s, s) float32 score plane, 1 GiB a head
ATTN_LONG = (1, 2, 16384, 64)
ATTN_SMALL = [((2, 2, 256, 64), "float32", True), ((2, 2, 256, 64), "float32", False),
              ((2, 2, 256, 16), "float32", False), ((2, 2, 256, 16), "bfloat16", True),
              ((2, 2, 256, 32), "bfloat16", True), ((2, 2, 256, 128), "bfloat16", True),
              ((2, 2, 200, 64), "bfloat16", True), ((2, 2, 200, 64), "bfloat16", False),
              ((2, 2, 256, 16), "bfloat16", False),
              # 100 queries over 300 keys: (b, h, sq, d) and sk
              ((2, 2, 100, 64), "bfloat16", False, 300)]
#: kernel vs plain version on the same inputs, as (atol, rtol) in |kernel -
#: plain| <= atol + rtol * scale elementwise, where scale is the output's
#: absolute product (``attention.flash_error_scales``: P|V|, |dS||K|, ...).
#: float32: the same sums in other orders, and f32 atomics in K5's dQ.
#: bfloat16 (unit roundoff u = 2^-8): kernel and plain version each round p
#: or dS to bfloat16 against other running maxima or after other sums, at
#: most u of each term, so the sums differ by at most 2u of the absolute
#: product; each rounds its output too, at most u of it: 4u = 2^-6 in all.
#: atol 1e-6 is float32 summation noise; where dS = p (dP - delta) cancels
#: (exactly 0 at a query that sees one key) both sides sum dP in order of d,
#: so the noise left there is the same. The lse (float32 in both dtypes) is
#: held against |lse| at LSE_TOL.
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2.0 ** -6)}
LSE_TOL = (1e-5, 1e-6)
GPT2_SMALL = ["--vocab", "50304", "--d-model", "768", "--n-heads", "12", "--n-layers", "12",
              "--d-ff", "3072", "--dtype", "bfloat16", "--pos-encoding", "rope",
              "--batch", "8", "--seq", "2048"]
LM_STEPS = 10
LM_LR = 0.5
#: relative L2 distance allowed between the split- and fused-backward steps'
#: parameter updates: K5 sums dQ with f32 atomics in run-dependent order, the
#: split kernels in a fixed one, and bfloat16 roundings downstream of dQ
#: (dq cast, then every earlier layer's backward) can land one step apart
SPLIT_UPDATE_TOL = 1e-2
#: K8 against its reference, |kernel - reference| <= atol + rtol * scale with
#: scale = ``decode_error_scale`` (P·|V| over the three parts, P·scale_v·|V8|
#: under int8). float32: the JAX test's tolerance. bfloat16 and int8: the
#: bound of ATTN_TOL — the reference rounds each weight p (times scale_v) to
#: bfloat16 before its P·V products and the kernel does not (at most u =
#: 2^-8 of each term), and each rounds its output: 4u = 2^-6 in all.
DECODE_TOL = {"float32": (2e-6, 2e-5), "bfloat16": (1e-6, 2.0 ** -6)}
DECODE_MAIN = (32, 12, 64, 16)  # b, h, head_dim, ring slots at GPT-2-small decode
GPT2_DECODE = dict(vocab_size=50304, d_model=768, n_heads=12, n_layers=12, d_ff=3072)
GEN_BATCH, GEN_PROMPT, GEN_NEW = 32, 128, 256
#: teacher-forced logits, K8 against the reference on the same tokens: the
#: relative L2 distance of the logits. Each attention output may move by 2^-6
#: of its absolute product (DECODE_TOL) at every layer; bfloat16 logits
#: themselves are rounded at 2^-8. Allowed: 2^-5 over the 32 steps.
TEACHER_TOL = 2.0 ** -5
#: kernel-name substrings grouping one decode step's device time
DECODE_GROUPS = {
    "K8 decode_attention": ["decode_attention_kernel"],
    "matmul": ["gemm", "Gemm", "nvjet", "xmma", "cutlass"],
    "layer_norm": ["layer_norm", "LayerNorm"],
    "index/scatter": ["index", "scatter", "gather"],
}
SERVE_REQUESTS = 16

#: K3 at the ladder's bias+relu tail and the other shapes it is held at
BIAS_RELU_SHAPES = [(4096, 384), (256, 4, 4, 384), (1000, 37)]
#: K7 against head_update_plain on the update, |kernel - plain| <= 2^-23 |W|
#: + atol + rtol * lr * (|dl|^T |h|) elementwise. 2^-23 |W| is each side's
#: one float32 rounding of W - lr dW. bfloat16 (u = 2^-8): each side rounds
#: each dl term to bfloat16, and where the two exponentials differ in their
#: last bits the roundings can land one step apart, 2u = 2^-7 of the term;
#: the products are exact in float32 and their sums differ by order, at most
#: (N - 1) 2^-24 of the absolute product (2^-10 at N = 16384): 2^-7 + 2^-10.
#: float32: that summation bound alone, 2^-14 at N = 1000, held at 2^-12.
#: atol 1e-9 is float32 noise for updates that cancel to near zero.
HEAD_TOL = {"bfloat16": (1e-9, 2.0 ** -7 + 2.0 ** -10), "float32": (1e-9, 2.0 ** -12)}
HEAD_LR = 0.5
GPT2_HEAD = (8 * 2048, 768, 50304)  # N, D, V at GPT-2-small b8 x 2048
#: relative L2 distance allowed between the parameter updates of the fused
#: head step with K7 and without: the body's gradients differ only by K5's
#: run-dependent f32 dQ atomics (as SPLIT_UPDATE_TOL), the head's by the
#: order of its float32 sums
FUSED_HEAD_UPDATE_TOL = SPLIT_UPDATE_TOL
#: the AD step against the fused one (bf16): the AD loss rounds each row's CE,
#: the masked sum and the quotient to bfloat16 (u = 2^-8 each, 3u) and divides
#: by sum(mask) = 16376 rounded to 16384 in bfloat16 (2^-11); the fused loss
#: is float32 throughout
AD_LOSS_TOL = 3 * 2.0 ** -8 + 2.0 ** -11
#: their updates: the AD step rounds the lm_head gradient and its dlogits to
#: bfloat16 where the fused step keeps float32, scales every gradient by the
#: same 16376/16384, and K5's atomics differ from run to run (1e-2)
AD_UPDATE_TOL = 2.0 ** -5

#: kernel-name substrings grouping one LM step's device time (first match wins)
PROFILE_GROUPS = {
    "K4 flash_fwd": ["flash_fwd_tc_kernel"],
    "K5 flash_bwd_fused": ["flash_bwd_tc_kernel"],
    "K6a flash_bwd_dq": ["flash_bwd_dq_tc_kernel"],
    # the scalar K6a (float32 only; no profiled step runs it)
    "K6a scalar": ["flash_bwd_dq_kernel"],
    "K6b flash_bwd_dkv": ["flash_bwd_dkv_tc_kernel"],
    # the scalar K5 and K6b (float32 only; no profiled step runs them)
    "K5/K6b scalar": ["flash_bwd_kv_kernel"],
    "K7 fused_head": ["head_update"],
    "matmul": ["gemm", "Gemm", "nvjet", "xmma", "cutlass"],
    "softmax_ce": ["softmax", "nll_loss", "cross_entropy"],
    "layer_norm": ["layer_norm", "LayerNorm"],
}


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 200) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls after 5
    warm-up calls, by ``utils.devtime.device_time`` (CUDA events, the calls
    queued behind a busy wait so host overhead does not show). ``fn`` returns
    a tensor on the card."""
    from distributed_ml_pytorch_tpu_torch.utils.devtime import device_time

    return device_time(fn, calls=iters, warmup=5).per_call_ms


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------------ phase 1

def phase_device_and_build(torch):
    from distributed_ml_pytorch_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    t0 = time.monotonic()
    _build.load("fused_update")
    _build.load("fused_conv")
    _build.load("attention")
    _build.load("flash_fwd_tc")
    _build.load("flash_bwd_tc")
    _build.load("decode_attention")
    _build.load("bias_relu")
    _build.load("fused_head")
    build_s = time.monotonic() - t0
    ptxas = [ln.strip() for ln in _build.build_logs().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device_and_build", "device": name,
          "count": torch.cuda.device_count(), "nvidia_smi": nvidia_smi_line(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "nvcc_build_s": _build.build_seconds,
          "ptxas": ptxas})
    for src in ("flash_fwd_tc", "flash_bwd_tc", "decode_attention"):
        emit({"phase": f"{src}_ptxas", "lines": [
            ln.strip() for ln in _build.build_logs(src).splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]})


# ------------------------------------------------------------------ phase 2

def phase_kernels(torch):
    import torch.nn.functional as F

    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # K1 flat_axpy at AlexNet's padded length, two alphas, bit-identical
    n = ALEXNET_PADDED
    y0 = torch.randn(n, generator=g, device=dev)
    x = torch.randn(n, generator=g, device=dev)
    err = 0.0
    for alpha in (1.0, -0.008):
        yk = fu.flat_axpy_cuda(y0.clone(), x, alpha)
        yp = fu.flat_axpy_plain(y0.clone(), x, alpha)
        torch.cuda.synchronize()
        require(torch.equal(yk, yp), f"flat_axpy kernel != plain at alpha={alpha}")
        err = max(err, float((yk - yp).abs().max()))
    # cold: eight operand pairs in turn (158 MB) so no launch finds its
    # operands in the 50 MB L2; warm: one pair, which fits in L2
    pairs = [(y0.clone(), x.clone()) for _ in range(8)]
    turn = [0]

    def cold(fn):
        def call():
            yb, xb = pairs[turn[0] % len(pairs)]
            turn[0] += 1
            return fn(yb, xb)
        return call

    ybuf = y0.clone()
    out["flat_axpy"] = {
        "max_abs_err": err,
        "ms": device_ms(cold(lambda yb, xb: fu.flat_axpy_cuda(yb, xb, 1.0))),
        "plain_ms": device_ms(cold(lambda yb, xb: fu.flat_axpy_plain(yb, xb, 1.0))),
        "library_ms": device_ms(cold(lambda yb, xb: yb.add_(xb, alpha=1.0))),
        "warm_ms": device_ms(lambda: fu.flat_axpy_cuda(ybuf, x, 1.0)),
        "warm_library_ms": device_ms(lambda: ybuf.add_(x, alpha=1.0)),
        "bound_ms": bound_ms(3 * 4 * n),
        "note": f"n={n}: {3 * 4 * n} B; ms/plain_ms/library_ms cold (L2 flushed "
                f"by rotation), warm_* with the operands L2-resident",
    }

    # K2a/K2b relu_pool2 at AlexNet's three epilogue shapes, batch 64
    fwd = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "shapes": []}
    bwd = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
           "bound_ms": 0.0, "shapes": []}
    for shape in POOL_SHAPES:
        nb, h, w, c = shape
        xr = torch.randn(shape, generator=g, device=dev)
        # forced ties: half-step values repeat inside windows, and windows of
        # negatives all tie at 0 after relu
        xt = torch.round(xr * 2) / 2
        pooled = (nb, h // 2, w // 2, c)
        gr = torch.randn(pooled, generator=g, device=dev)
        for xin in (xr, xt):
            for bias in (None, torch.randn(c, generator=g, device=dev)):
                mk = fc.relu_pool2_fwd_cuda(xin, bias)
                mp = fc.relu_pool2_fwd_plain(xin, bias)
                dk = fc.relu_pool2_bwd_cuda(xin, bias, mk, gr)
                dp = fc.relu_pool2_bwd_plain(xin, bias, mp, gr)
                torch.cuda.synchronize()
                require(torch.equal(mk, mp), f"relu_pool2 fwd kernel != plain at {shape}")
                require(torch.equal(dk, dp), f"relu_pool2 bwd kernel != plain at {shape}")
                fwd["max_abs_err"] = max(fwd["max_abs_err"], float((mk - mp).abs().max()))
                bwd["max_abs_err"] = max(bwd["max_abs_err"], float((dk - dp).abs().max()))
        m = fc.relu_pool2_fwd_cuda(xr)
        x_cl = xr.permute(0, 3, 1, 2)  # NCHW shape, channels_last memory
        t_fwd = device_ms(lambda: fc.relu_pool2_fwd_cuda(xr))
        t_bwd = device_ms(lambda: fc.relu_pool2_bwd_cuda(xr, None, m, gr))
        row = {
            "shape": list(shape),
            "fwd_ms": t_fwd, "bwd_ms": t_bwd,
            "fwd_plain_ms": device_ms(lambda: fc.relu_pool2_fwd_plain(xr)),
            "bwd_plain_ms": device_ms(lambda: fc.relu_pool2_bwd_plain(xr, None, m, gr)),
            "fwd_library_ms": device_ms(lambda: F.max_pool2d(F.relu(x_cl), 2)),
            "fwd_bound_ms": bound_ms(4 * (xr.numel() + m.numel())),
            "bwd_bound_ms": bound_ms(4 * (2 * xr.numel() + 2 * m.numel())),
        }
        for key, agg in (("fwd", fwd), ("bwd", bwd)):
            agg["ms"] += row[f"{key}_ms"]
            agg["plain_ms"] += row[f"{key}_plain_ms"]
            agg["bound_ms"] += row[f"{key}_bound_ms"]
        fwd["library_ms"] += row["fwd_library_ms"]
        fwd["shapes"].append(row)
    out["relu_pool2_fwd"] = fwd
    out["relu_pool2_bwd"] = bwd
    emit({"phase": "kernels_vs_plain", "ok": True, **{
        k: {kk: vv for kk, vv in v.items() if kk != "shapes"} for k, v in out.items()},
        "pool_shapes": fwd["shapes"]})
    return out


# ------------------------------------------------------------------ phase 3

def phase_trainer(torch, device="cuda", steps=5, batch=64):
    from distributed_ml_pytorch_tpu_torch.data import load_cifar10
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        SGD,
        make_train_step,
        to_device,
    )
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    full_float32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    x, y, *_ = load_cifar10(synthetic=True, n_train=steps * batch, n_test=16)
    runs = {}
    for fused in (True, False):
        model = get_model("alexnet", fused_epilogue=fused, seed=0, device=device)
        step = make_train_step(model, SGD(0.008))
        before = dict(fc.launches)
        losses = [float(step(*to_device(x[i * batch:(i + 1) * batch],
                                        y[i * batch:(i + 1) * batch], device)))
                  for i in range(steps)]
        runs[fused] = (losses, ravel_model_params(model),
                       {k: fc.launches[k] - before[k] for k in before})
    (lf, pf, kf), (lu, pu, _ku) = runs[True], runs[False]
    bit_equal = lf == lu and torch.equal(pf, pu)
    param_err = float((pf - pu).abs().max())
    loss_err = max(abs(a - b) for a, b in zip(lf, lu))
    emit({"phase": "trainer_fused_vs_unfused", "steps": steps, "batch": batch,
          "losses_fused": lf, "losses_unfused": lu, "bit_equal": bit_equal,
          "max_param_abs_err": param_err, "max_loss_abs_err": loss_err,
          "k2_launches": kf})
    # the kernels reproduce the unfused chain's numbers exactly, so equality
    # is expected; 1e-6 absolute is allowed only for cuDNN picking a
    # different deterministic algorithm between the two models' calls
    require(param_err <= 1e-6 and loss_err <= 1e-6,
            f"fused and unfused trainer steps disagree: params {param_err}, loss {loss_err}")
    if torch.device(device).type == "cuda":
        require(kf["relu_pool2_fwd"] == 3 * steps and kf["relu_pool2_bwd"] == 3 * steps,
                f"fused trainer steps launched the K2 kernels {kf} times")


# ------------------------------------------------------------------ phase 4

def phase_downpour(torch, device="cuda", steps=WORKER_STEPS, batch=64):
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import run_server, train_worker
    from distributed_ml_pytorch_tpu_torch.training.cli import build_parser
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        InProcessTransport,
        MessageCode,
    )

    args = build_parser().parse_args([
        "--epochs", "1", "--synthetic-data",
        "--synthetic-train-size", str(steps * batch), "--synthetic-test-size", "512",
        "--batch-size", str(batch), "--log-interval", str(10 * steps),
        "--worker-timeout", "0", "--log-dir", os.path.join(ROOT, "build", "smoke_runs"),
    ])
    world = InProcessTransport.create_world(3)
    results, errors = {}, []

    def guard(name, fn):
        try:
            results[name] = fn()
        except BaseException as e:  # noqa: BLE001 — reported and failed below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    fu.launches = 0
    for k in fc.launches:
        fc.launches[k] = 0
    t0 = time.monotonic()
    # daemon threads: a hung world fails the run below instead of keeping
    # the process alive
    server = threading.Thread(target=guard, daemon=True,
                              args=("server", lambda: run_server(args, world[0])))
    workers = [threading.Thread(target=guard, daemon=True, args=(
        r, lambda r=r: train_worker(args, world[r], device=device))) for r in (1, 2)]
    server.start()
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=600)
    server.join(timeout=60)
    wall = time.monotonic() - t0
    launches = {"flat_axpy": fu.launches, **fc.launches}
    require(not errors, "; ".join(errors))
    require(not server.is_alive() and not any(t.is_alive() for t in workers),
            "the DownPour world did not shut down")
    srv = results["server"]
    per_worker = {}
    for r in (1, 2):
        _model, logger = results[r]
        recs = logger.records
        losses = [rec["training_loss"] for rec in recs]
        span = (recs[-1]["timestamp"] - recs[5]["timestamp"]).total_seconds()
        sps = (len(recs) - 6) / span
        per_worker[r] = {"steps": len(recs), "early_loss": sum(losses[:10]) / 10,
                         "late_loss": sum(losses[-10:]) / 10,
                         "steps_per_s": sps, "images_per_s": sps * batch}
    counts = {c.name: n for c, n in srv.message_counts.items() if n}
    emit({"phase": "downpour_world", "workers": 2, "batch": batch, "wall_s": wall,
          "per_worker": per_worker, "server_messages": counts,
          "central_finite": bool(__import__("numpy").isfinite(srv.central).all()),
          "launches": launches})
    total_steps = sum(w["steps"] for w in per_worker.values())
    require(all(w["steps"] == steps for w in per_worker.values()), "workers took too few steps")
    require(srv.message_counts[MessageCode.GradientUpdate] >= 2 * (steps // 10),
            "server counted too few GradientUpdates")
    require(srv.message_counts[MessageCode.ParameterRequest] >= 2 * (steps // 10),
            "server counted too few ParameterRequests")
    require(__import__("numpy").isfinite(srv.central).all(), "central vector not finite")
    for r, w in per_worker.items():
        require(w["late_loss"] < w["early_loss"], f"worker {r} loss did not fall: {w}")
    if torch.device(device).type == "cuda":
        require(launches["flat_axpy"] == total_steps,
                f"flat_axpy launched {launches['flat_axpy']} times for {total_steps} steps")
        require(launches["relu_pool2_fwd"] > 0 and launches["relu_pool2_bwd"] > 0,
                f"relu_pool2 kernels not launched on the main path: {launches}")
    return launches


# ------------------------------------------------------------------ phase 5

def _err(torch, got, want, scale, tol):
    """(max abs error, max of error / scale, within atol + rtol * scale)."""
    diff = (got.float() - want.float()).abs()
    atol, rtol = tol
    ok = bool((diff <= atol + rtol * scale).all())
    return float(diff.max()), float((diff / scale.clamp_min(1e-30)).max()), ok


def _attn_inputs(torch, shape, dtype, g, sk=None):
    b, h, s, d = shape
    mk = lambda n: torch.randn((b * h, n, d), generator=g, device="cuda").to(dtype)
    return mk(s), mk(sk or s), mk(sk or s), mk(s)


def _attn_check(torch, at, shape, dtype_name, causal, g, sk=None):
    """Every kernel against its plain version on one input set (``sk`` keys,
    by default as many as queries); returns ``{kernel: {tensor: (max_abs,
    max error / scale)}}`` and raises on a miss, naming every miss."""
    dtype = getattr(torch, dtype_name)
    tol = ATTN_TOL[dtype_name]
    q, k, v, do = _attn_inputs(torch, shape, dtype, g, sk)
    out_k, lse_k = at.flash_fwd_cuda(q, k, v, causal)
    out_p, lse_p = at.flash_fwd_plain(q, k, v, causal)
    # the backward kernels get the plain forward's lse and delta, so each
    # kernel's error is its own
    delta = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, causal)
    fused = at.flash_bwd_fused_cuda(*args)
    dq_s = at.flash_bwd_dq_cuda(*args)
    dq_again = at.flash_bwd_dq_cuda(*args)
    dk_s, dv_s = at.flash_bwd_dkv_cuda(*args)
    dq_p, dk_p, dv_p = at.flash_bwd_fused_plain(*args)
    sc = at.flash_error_scales(*args)
    torch.cuda.synchronize()
    checks = {
        "flash_fwd": {"out": (out_k, out_p, sc["out"], tol),
                      "lse": (lse_k, lse_p, lse_p.abs(), LSE_TOL)},
        "flash_bwd_fused": {"dq": (fused[0], dq_p, sc["dq"], tol),
                            "dk": (fused[1], dk_p, sc["dk"], tol),
                            "dv": (fused[2], dv_p, sc["dv"], tol)},
        "flash_bwd_dq": {"dq": (dq_s, dq_p, sc["dq"], tol)},
        "flash_bwd_dkv": {"dk": (dk_s, dk_p, sc["dk"], tol), "dv": (dv_s, dv_p, sc["dv"], tol)},
    }
    errs, misses = {}, []
    for kern, tensors in checks.items():
        errs[kern] = {}
        for name, (got, want, scale, t) in tensors.items():
            require(bool(torch.isfinite(got.float()).all()),
                    f"{kern} {name} not finite at {shape} {dtype_name} causal={causal}")
            mx, rel, ok = _err(torch, got, want, scale, t)
            errs[kern][name] = (mx, rel)
            if not ok:
                misses.append(f"{kern} {name}: max abs err {mx}, max err / scale {rel}, "
                              f"(atol, rtol) {t}")
    require(not misses, f"kernel != plain at {shape} {dtype_name} causal={causal}: "
                        f"{'; '.join(misses)}")
    # K6b is K5 without dQ: the same dK and dV, bit for bit
    require(torch.equal(dk_s, fused[1]) and torch.equal(dv_s, fused[2]),
            f"K6b's dK/dV differ from K5's at {shape} {dtype_name} causal={causal}: max "
            f"{float((dk_s.float() - fused[1].float()).abs().max())} / "
            f"{float((dv_s.float() - fused[2].float()).abs().max())}")
    # K6a keeps dQ in registers, with no atomics: the same bits every launch
    require(torch.equal(dq_s, dq_again),
            f"K6a's dQ differs between two launches at {shape} {dtype_name} causal={causal}")
    return errs, (q, k, v, do, lse_p, delta)


def _attn_bytes(shape, dtype_bytes, kern):
    """Bytes each kernel must move once: its tensor inputs and outputs."""
    b, h, s, d = shape
    t = b * h * s * d * dtype_bytes  # one (b*h, s, d) tensor
    r = b * h * s * 4                # one (b*h, s) f32 row vector
    return {"flash_fwd": 4 * t + r,                 # q, k, v -> out, lse
            "flash_bwd_fused": 7 * t + 2 * r,       # q, k, v, do, lse, delta -> dq, dk, dv
            "flash_bwd_dq": 5 * t + 2 * r,          # ... -> dq
            "flash_bwd_dkv": 6 * t + 2 * r}[kern]   # ... -> dk, dv


def phase_attention(torch):
    import torch.nn.functional as F

    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.utils.flops import flash_attention_train_flops

    g = torch.Generator(device="cuda").manual_seed(1)
    cases = {}
    for shape, dtype_name, causal, *sk in ATTN_SMALL:
        errs, _ = _attn_check(torch, at, shape, dtype_name, causal, g, *sk)
        cases[f"{shape}{f' sk={sk[0]}' if sk else ''} {dtype_name} causal={causal}"] = errs
    t0 = time.monotonic()
    errs, long_args = _attn_check(torch, at, ATTN_LONG, "bfloat16", True, g)
    long_case = {"shape": ATTN_LONG, "key_tiles": ATTN_LONG[2] // 64,
                 "check_wall_s": time.monotonic() - t0,
                 "k6a_ms": device_ms(lambda: at.flash_bwd_dq_cuda(*long_args, True), 10)}
    del long_args
    cases[f"{ATTN_LONG} bfloat16 causal=True"] = errs
    errs, (q, k, v, do, lse, delta) = _attn_check(torch, at, ATTN_MAIN, "bfloat16", True, g)
    cases[f"{ATTN_MAIN} bfloat16 causal=True"] = errs

    b, h, s, d = ATTN_MAIN
    args = (q, k, v, do, lse, delta, True)
    # one product over the causal score plane, from the ported FLOP count
    # (the fused train step's attention is 7 such products)
    unit = flash_attention_train_flops(b, h, s, d, 1, causal=True, bwd_impl="fused") / 7
    products = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}
    iters = 10
    timed = {
        "flash_fwd": lambda: at.flash_fwd_cuda(q, k, v, True),
        "flash_bwd_fused": lambda: at.flash_bwd_fused_cuda(*args),
        "flash_bwd_dq": lambda: at.flash_bwd_dq_cuda(*args),
        "flash_bwd_dkv": lambda: at.flash_bwd_dkv_cuda(*args),
    }
    plain = {
        "flash_fwd": lambda: at.flash_fwd_plain(q, k, v, True),
        "flash_bwd_fused": lambda: at.flash_bwd_fused_plain(*args),
        "flash_bwd_dq": lambda: at.flash_bwd_split_plain(*args),
        "flash_bwd_dkv": lambda: at.flash_bwd_split_plain(*args),
    }
    # the library yardstick: SDPA on (b, h, s, d), forward alone and its
    # backward alone (retained graph), and the two together
    q4, k4, v4, do4 = (t.reshape(b, h, s, d) for t in (q, k, v, do))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(o, (qg, kg, vg), do4)

    sdpa = {
        "fwd": device_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), iters),
        "bwd": device_ms(lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), do4, retain_graph=True), iters),
        "fwd_bwd": device_ms(sdpa_fwd_bwd, iters),
    }
    out = {}
    for kern in timed:
        flop_ms = products[kern] * unit / BF16_FLOPS * 1e3
        byte_ms = bound_ms(_attn_bytes(ATTN_MAIN, 2, kern))
        out[kern] = {
            "max_abs_err": max(e[0] for c in cases.values() for e in c[kern].values()),
            "ms": device_ms(timed[kern], iters),
            "plain_ms": device_ms(plain[kern], 3),
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": {"flash_fwd": sdpa["fwd"], "flash_bwd_fused": sdpa["bwd"]}.get(kern),
            "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
        }
    pair_ms = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    emit({"phase": "attention_vs_plain", "ok": True, "tolerance": ATTN_TOL,
          "k6b_dkv_bit_identical_to_k5": True, "k6a_dq_bit_identical_across_launches": True,
          "lse_tolerance": LSE_TOL, "cases": cases, "long_case": long_case,
          "sdpa_ms": sdpa, "main_shape": ATTN_MAIN,
          "k4_over_sdpa_fwd": out["flash_fwd"]["ms"] / sdpa["fwd"],
          "k4_bound_share": out["flash_fwd"]["bound_ms"] / out["flash_fwd"]["ms"],
          "k5_over_sdpa_bwd": out["flash_bwd_fused"]["ms"] / sdpa["bwd"],
          "k5_bound_share": out["flash_bwd_fused"]["bound_ms"] / out["flash_bwd_fused"]["ms"],
          "k6a_bound_share": out["flash_bwd_dq"]["bound_ms"] / out["flash_bwd_dq"]["ms"],
          "k6b_bound_share": out["flash_bwd_dkv"]["bound_ms"] / out["flash_bwd_dkv"]["ms"],
          # the split pair computes what SDPA's backward computes (dQ, dK, dV)
          "k6_pair_ms": pair_ms, "k6_pair_over_sdpa_bwd": pair_ms / sdpa["bwd"],
          "timed": {k: {kk: vv for kk, vv in v.items() if kk != "max_abs_err"}
                    for k, v in out.items()}})
    return out


# ------------------------------------------------------------------ phase 6

def _zero_attention_launches(at):
    for name in at.launches:
        at.launches[name] = 0


def phase_lm(torch, steps=LM_STEPS):
    import functools

    from distributed_ml_pytorch_tpu_torch.models.transformer import Dense
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.training import train_lm
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown
    from distributed_ml_pytorch_tpu_torch.utils.devtime import device_time
    from distributed_ml_pytorch_tpu_torch.utils.flops import (
        device_peak_flops,
        lm_train_flops_6nd,
    )

    args = train_lm.parse_args([*GPT2_SMALL, "--steps", str(steps), "--lr", str(LM_LR),
                                "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    _zero_attention_launches(at)
    t0 = time.monotonic()
    res = train_lm.run(args)
    wall = time.monotonic() - t0
    launches = dict(at.launches)
    model = res.state.model
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    n_layers, heads = args.n_layers, args.n_heads
    step_s = res.steady_s / (steps - 1)
    n_matmul = sum(m.weight.numel() for m in model.modules() if isinstance(m, Dense))
    flops = lm_train_flops_6nd(n_matmul, args.batch, args.seq, heads, args.d_model // heads,
                               n_layers)
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    main = {"steps": steps, "losses": res.losses, "params_finite": finite,
            "steps_per_s": 1.0 / step_s, "tokens_per_s": res.tokens_per_s,
            "step_ms": step_s * 1e3, "flops_per_step": flops, "matmul_params": n_matmul,
            "mfu_bf16": flops / step_s / peak if peak else None,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "wall_s": wall,
            "launches": launches}
    require(res.losses[-1] < res.losses[0], f"LM loss did not fall: {res.losses}")
    require(finite, "LM parameters not finite after training")
    require(launches["flash_fwd"] == n_layers * steps
            and launches["flash_bwd_fused"] == n_layers * steps,
            f"K4/K5 launched {launches} times for {steps} steps of {n_layers} layers")
    require(launches["flash_bwd_dq"] == 0 and launches["flash_bwd_dkv"] == 0,
            f"the split backward ran on the fused path: {launches}")

    # where one more step's time goes on the card (torch.profiler)
    main["profile"] = kernel_breakdown(
        lambda: res.step_fn(res.state, res.tokens, res.targets), PROFILE_GROUPS)
    require("group_ms" in main["profile"],
            f"the profiled LM step recorded no kernel: {main['profile']}")
    groups = main["profile"]["group_ms"]
    require(groups["K4 flash_fwd"] > 0,
            f"the profiled LM step shows no tensor-core K4: {main['profile']}")
    require(groups["K5 flash_bwd_fused"] > 0 and groups["K5/K6b scalar"] == 0,
            f"the profiled LM step's K5 is not the tensor-core kernel: {main['profile']}")

    # one step from the trained weights, fused and then split; the forward is
    # the same kernel on the same weights, so the losses must be equal
    params = list(model.parameters())
    w0 = [p.detach().clone() for p in params]
    _zero_attention_launches(at)
    _state, loss_f = res.step_fn(res.state, res.tokens, res.targets)
    upd_f = [p.detach() - w for p, w in zip(params, w0)]
    with torch.no_grad():
        for p, w in zip(params, w0):
            p.copy_(w)
    model.set_attn_fn(functools.partial(at.flash_attention, causal=True, bwd_impl="split"))
    _zero_attention_launches(at)
    _state, loss_s = res.step_fn(res.state, res.tokens, res.targets)
    split_launches = dict(at.launches)
    model.set_attn_fn(None)
    upd_s = [p.detach() - w for p, w in zip(params, w0)]
    diff = max(float((a - b).abs().max()) for a, b in zip(upd_s, upd_f))
    scale = max(float(a.abs().max()) for a in upd_f)
    num = sum(float(((a - b).float() ** 2).sum()) for a, b in zip(upd_s, upd_f)) ** 0.5
    den = sum(float((a.float() ** 2).sum()) for a in upd_f) ** 0.5
    split = {"loss_fused": float(loss_f), "loss_split": float(loss_s),
             "max_abs_update_diff": diff, "max_abs_update": scale,
             "rel_update_diff_l2": num / den, "launches": split_launches}

    # both steps timed as the AD step is (one warm-up, three steps, device
    # time), then one split step profiled: K6a and K6b by kernel name
    def one_step():
        return res.step_fn(res.state, res.tokens, res.targets)[1]

    split["fused_step_ms"] = device_time(one_step, calls=3, warmup=1).per_call_ms
    model.set_attn_fn(functools.partial(at.flash_attention, causal=True, bwd_impl="split"))
    split["split_step_ms"] = device_time(one_step, calls=3, warmup=1).per_call_ms
    split["profile"] = kernel_breakdown(one_step, PROFILE_GROUPS)
    model.set_attn_fn(None)
    emit({"phase": "lm_gpt2_small", "config": GPT2_SMALL, "lr": LM_LR, **main,
          "split_step": split})
    require(float(loss_f) == float(loss_s),
            f"split-backward step loss {float(loss_s)} != fused {float(loss_f)}")
    require(split_launches["flash_bwd_dq"] == n_layers and
            split_launches["flash_bwd_dkv"] == n_layers and
            split_launches["flash_bwd_fused"] == 0,
            f"the split step launched {split_launches}")
    require(num / den <= SPLIT_UPDATE_TOL,
            f"split and fused updates differ: relative L2 {num / den} > {SPLIT_UPDATE_TOL}")
    require("group_launches" in split["profile"],
            f"the profiled split step recorded no kernel: {split['profile']}")
    calls = split["profile"]["group_launches"]
    require(calls["K6b flash_bwd_dkv"] == n_layers and calls["K6a flash_bwd_dq"] == n_layers
            and calls["K5/K6b scalar"] == 0 and calls["K6a scalar"] == 0
            and calls["K5 flash_bwd_fused"] == 0,
            f"the profiled split step's backward kernels: {calls}")
    return launches, split_launches


def phase_default_widths(torch):
    """``train_lm`` and the serving demo with no width flags: the JAX
    defaults, d_model 128 in 8 heads (head_dim 16), float32."""
    import contextlib
    import io

    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.serving import cli as serving_cli
    from distributed_ml_pytorch_tpu_torch.training import train_lm

    args = train_lm.parse_args(["--steps", "3"])
    _zero_attention_launches(at)
    res = train_lm.run(args)
    launches = dict(at.launches)
    da.launches = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = serving_cli.main(["--demo", "4"])
    k8 = da.launches
    emit({"phase": "default_widths", "d_model": args.d_model, "n_heads": args.n_heads,
          "head_dim": args.d_model // args.n_heads, "dtype": args.dtype,
          "train_lm_losses": res.losses, "train_lm_launches": launches,
          "serving_demo_rc": rc, "serving_k8_launches": k8})
    require(all(math.isfinite(x) for x in res.losses),
            f"default-width train_lm losses not finite: {res.losses}")
    require(launches["flash_fwd"] == args.n_layers * 3
            and launches["flash_bwd_fused"] == args.n_layers * 3,
            f"default-width train_lm launched {launches}")
    require(rc == 0 and "serving demo complete" in text.getvalue() and k8 > 0,
            f"default-width serving demo: rc {rc}, K8 launches {k8}")


# ------------------------------------------------------------------ phase 7

def _decode_case(torch, g, b, h, C, T, d, dtype, quant, t, ring_base, pad=0):
    """K8's inputs on the card; the big cache is a live-prefix view of a
    ``C + pad`` allocation."""
    from distributed_ml_pytorch_tpu_torch.models.transformer import quantize_kv

    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    q, kn, vn = (mk(b, h, 1, d).to(dtype) for _ in range(3))
    rk, rv = (mk(b, h, T, d).to(dtype) for _ in range(2))
    bk, bv = mk(b, h, C + pad, d), mk(b, h, C + pad, d)
    sk = sv = None
    if quant:
        (bk, sk), (bv, sv) = quantize_kv(bk), quantize_kv(bv)
        sk, sv = sk[:, :, :C], sv[:, :, :C]
    else:
        bk, bv = bk.to(dtype), bv.to(dtype)
    tt = torch.as_tensor(t, dtype=torch.int32, device="cuda")
    rb = torch.as_tensor(ring_base, dtype=torch.int32, device="cuda")
    return (q, kn, vn, bk[:, :, :C], bv[:, :, :C], rk, rv, tt, rb, sk, sv)


def _cold(sets, fn):
    """``fn`` over the input sets in turn, one set a call (for timing cold:
    the sets together hold more than the L2)."""
    turn = [0]

    def call():
        turn[0] += 1
        return fn(*sets[turn[0] % len(sets)])
    return call


def _decode_bytes(args):
    """Bytes K8 must move for these inputs: q, k_new, v_new and out, the
    live keys of K and V (and their scales), the filled ring slots."""
    q, kn, vn, bk, bv, rk, rv, t, rb, sk, _sv = args
    b, h, _, d = q.shape
    live = int(rb.clamp(0, bk.shape[2]).expand(b).sum())
    fill = int(t.clamp(0, rk.shape[2]).expand(b).sum())
    per_key = 2 * d * bk.element_size() + (8 if sk is not None else 0)
    return (4 * b * h * d * q.element_size() + h * live * per_key
            + h * fill * 2 * d * rk.element_size())


def phase_decode_attention(torch):
    import functools

    import torch.nn.functional as F

    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(7)
    b, h, d, T = DECODE_MAIN
    cases = []
    for name, quant in (("bfloat16", False), ("int8", True)):
        for C in (128, 256, 383):
            for t in (0, 5, 15):
                rb = torch.randint(0, C + 1, (b,), generator=g, device="cuda")
                cases.append((f"{name} C={C} t={t} per-row ring_base",
                              (b, h, C, T, d, torch.bfloat16, quant, t, rb, 16)))
        cases.append((f"{name} C=8192", (b, h, 8192, T, d, torch.bfloat16, quant, 7,
                                         8192, 0)))
    for quant in (False, True):
        cases.append((f"float32 small quant={quant}",
                      (2, 2, 40, T, 64, torch.float32, quant, [0, 9], [40, 17], 8)))
    results, misses, worst = {}, [], 0.0
    for label, (cb, ch, C, cT, cd, dtype, quant, t, rb, pad) in cases:
        args = _decode_case(torch, g, cb, ch, C, cT, cd, dtype, quant, t, rb, pad)
        got = da.decode_attention_cuda(*args)
        want = da.decode_attention_reference(*args)
        scale = da.decode_error_scale(*args)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got.float()).all()), f"K8 not finite: {label}")
        tol = DECODE_TOL["float32" if dtype == torch.float32 else "bfloat16"]
        mx, rel, ok = _err(torch, got, want, scale, tol)
        results[label] = {"max_abs_err": mx, "max_err_over_scale": rel}
        worst = max(worst, mx)
        if not ok:
            misses.append(f"{label}: max abs {mx}, max err / scale {rel}, (atol, rtol) {tol}")
    require(not misses, "K8 != reference: " + "; ".join(misses))

    # the keys split over 1, 2, 4 and 8 blocks, forced, on the same inputs:
    # each within the bound of the reference and of one block per (b, h);
    # every fourth row has no live key in the big cache (ring_base 0)
    splits = {}
    for label, (sb, C, quant) in (("b32 C=383 bfloat16", (b, 383, False)),
                                  ("b32 C=383 int8", (b, 383, True)),
                                  ("b8 C=256 bfloat16", (8, 256, False)),
                                  ("b1 C=2048 bfloat16", (1, 2048, False)),
                                  ("b1 C=2048 int8", (1, 2048, True))):
        rb = torch.randint(0, C + 1, (sb,), generator=g, device="cuda")
        rb[::4] = 0
        t = torch.randint(0, T + 1, (sb,), generator=g, device="cuda")
        args = _decode_case(torch, g, sb, h, C, T, d, torch.bfloat16, quant, t, rb, 16)
        want = da.decode_attention_reference(*args)
        scale = da.decode_error_scale(*args)
        one = da.decode_attention_cuda(*args, splits=1)
        tol = DECODE_TOL["bfloat16"]
        splits[label] = {}
        for n in da.SPLITS:
            got = da.decode_attention_cuda(*args, splits=n)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got.float()).all()), f"K8 not finite: {label} S={n}")
            mx, rel, ok = _err(torch, got, want, scale, tol)
            mx1, rel1, ok1 = _err(torch, got, one, scale, tol)
            splits[label][n] = {"max_abs_err": mx, "max_err_over_scale": rel,
                                "vs_one_block_max_abs": mx1}
            worst = max(worst, mx)
            require(ok and ok1, f"K8 {label} at S={n}: against the reference {mx} ({rel} of "
                                f"the scale), against S=1 {mx1} ({rel1}), (atol, rtol) {tol}")

    # timed cold, as in the decode step (each layer reads its own cache):
    # input sets in turn, at least twice the 50 MB L2 in all. The decode
    # shape (256 live keys of a 384-row allocation, 8 ring slots filled,
    # every row alike) in both caches; batch-1 generate() at long context
    # and the serving engine's 8 slots, each also with one block per (b, h)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timed = {}
    for name, sb, live, pad, quant in (("bfloat16", b, 256, 128, False),
                                       ("int8", b, 256, 128, True),
                                       ("b1_live2048", 1, 2048, 256, False),
                                       ("b8_live256", 8, 256, 128, False)):
        first = _decode_case(torch, g, sb, h, live, T, d, torch.bfloat16, quant, 8, live, pad)
        n_sets = -(-2 * L2_BYTES // _decode_bytes(first))
        sets = [first] + [_decode_case(torch, g, sb, h, live, T, d, torch.bfloat16, quant, 8,
                                       live, pad) for _ in range(n_sets - 1)]
        entry = {"b": sb, "live": live, "alloc": live + pad,
                 "splits": da.decode_splits(sb * h, live, sms),
                 "ms": device_ms(_cold(sets, da.decode_attention_cuda), 200),
                 "plain_ms": device_ms(_cold(sets, da.decode_attention_reference), 50),
                 "bound_ms": bound_ms(_decode_bytes(sets[0])), "bound_by": "bytes",
                 "bytes": _decode_bytes(sets[0]), "library_ms": None}
        if sb < b:
            # the small batches at every split count, forced
            entry["ms_by_splits"] = {n: device_ms(_cold(sets, functools.partial(
                da.decode_attention_cuda, splits=n)), 200) for n in da.SPLITS}
        if not quant:
            # SDPA over K/V concatenated beforehand (the concat is not timed)
            sets[:] = [(a[0], torch.cat([a[3], a[5][:, :, :8], a[1]], dim=2),
                        torch.cat([a[4], a[6][:, :, :8], a[2]], dim=2)) for a in sets]
            entry["library_ms"] = device_ms(_cold(sets, F.scaled_dot_product_attention), 200)
        entry["input_sets"] = n_sets
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        timed[name] = entry
    emit({"phase": "decode_attention_vs_plain", "ok": True, "tolerance": DECODE_TOL,
          "cases": results, "forced_splits": splits, "sms": sms,
          "timed_shape": {"b": b, "h": h, "d": d, "T": T, "live": 256, "alloc": 384, "t": 8},
          "timed": timed})
    return {"decode_attention": {"max_abs_err": worst, **timed["bfloat16"]}}


# ------------------------------------------------------------------ phase 8

class _ReferenceCalls:
    """Counts calls of K8's reference while installed (on the card the
    model's decode step must never reach it)."""

    def __init__(self, da):
        self.da, self.n, self.real = da, 0, da.decode_attention_reference

    def __enter__(self):
        def counted(*a, **k):
            self.n += 1
            return self.real(*a, **k)
        self.da.decode_attention_reference = counted
        return self

    def __exit__(self, *exc):
        self.da.decode_attention_reference = self.real


def _teacher_forced_logits(torch, dec, prompt, feed, n_blocks):
    """Logits of ``n_blocks`` decode blocks that feed the given tokens
    (``feed[:, i]`` at step i), through the blocked decode's own cache
    handling."""
    gen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
    b, p = prompt.shape
    T = dec.decode_block
    cache = gen.init_cache(dec, b, dec.cache_size, T, dec.kv_quant)
    _logits, cache = dec(prompt, torch.arange(p, device="cuda")[None, :], cache=cache)
    big, small = gen.split_cache(cache)
    out = []
    for blk in range(n_blocks):
        live = p + blk * T
        view = gen._tree_slice_big(big, live)
        small = gen.reset_ring_state(small, live)
        for t in range(T):
            step = blk * T + t
            logits, cache = dec(feed[:, step:step + 1],
                                torch.full((b, 1), p + step, device="cuda"),
                                cache=gen.join_cache(view, small))
            _, small = gen.split_cache(cache)
            out.append(logits[:, -1].float())
        big = gen.merge_ring_caches(big, small, live)
    return torch.stack(out, dim=1)


def _decode_step_fn(torch, dec, prompt, live):
    """One single-token decode step of the blocked path at ``live`` cached
    rows (for the profiler)."""
    gen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
    b, p = prompt.shape
    cache = gen.init_cache(dec, b, dec.cache_size, dec.decode_block, dec.kv_quant)
    _logits, cache = dec(prompt, torch.arange(p, device="cuda")[None, :], cache=cache)
    big, small = gen.split_cache(cache)
    small = gen.reset_ring_state(small, live)
    view = gen._tree_slice_big(big, live)
    tok = prompt[:, -1:]
    pos = torch.full((b, 1), live, device="cuda")

    def step():
        with torch.no_grad():
            return dec(tok, pos, cache=gen.join_cache(view, small))
    return step


def phase_generate(torch):
    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.models.generate import (
        DECODE_BLOCK,
        _decode_model,
        generate,
    )
    from distributed_ml_pytorch_tpu_torch.models.transformer import Dense
    from distributed_ml_pytorch_tpu_torch.models import transformer as tr
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    model = TransformerLM(**GPT2_DECODE, max_len=GEN_PROMPT + GEN_NEW, dtype=torch.bfloat16,
                          pos_encoding="learned", seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, GPT2_DECODE["vocab_size"], (GEN_BATCH, GEN_PROMPT), generator=g,
                           device="cuda")
    L, H = GPT2_DECODE["n_layers"], GPT2_DECODE["n_heads"]
    hd = GPT2_DECODE["d_model"] // H
    n_pad = -(-(GEN_NEW - 1) // DECODE_BLOCK) * DECODE_BLOCK
    weight_bytes = 2 * sum(m.weight.numel() for m in model.modules() if isinstance(m, Dense))
    runs = {}
    for name, quant in (("bfloat16", False), ("int8", True)):

        def timed(new):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate(model, prompt, new, kv_quant=quant)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        timed(DECODE_BLOCK + 1)  # warm-up: cuBLAS handles and algorithms
        _o, t_short = timed(DECODE_BLOCK + 1)
        torch.cuda.reset_peak_memory_stats()
        da.launches = 0
        with _ReferenceCalls(da) as ref:
            out, wall = timed(GEN_NEW)
        launches = da.launches
        step_s = (wall - t_short) / (n_pad - DECODE_BLOCK)
        # bytes a decode step must read: the bf16 weights of every product,
        # plus the average live K/V (and scales) over the padded steps
        avg_live = GEN_PROMPT + (n_pad - 1) / 2
        per_key = 2 * hd * (1 if quant else 2) + (8 if quant else 0)
        kv_bytes = L * GEN_BATCH * H * avg_live * per_key
        step_bytes = weight_bytes + kv_bytes
        res = {"wall_s": wall, "tokens_per_s": GEN_BATCH * GEN_NEW / wall,
               "decode_step_ms": step_s * 1e3, "step_bytes": step_bytes,
               "weight_bytes": weight_bytes, "kv_bytes_avg": kv_bytes,
               "byte_roofline_share": step_bytes / HBM_BYTES_PER_S / step_s,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "k8_launches": launches, "reference_calls": ref.n,
               "short_run_s": t_short}
        require(out.shape == (GEN_BATCH, GEN_PROMPT + GEN_NEW), f"generate shape {out.shape}")
        require(bool(((out >= 0) & (out < GPT2_DECODE["vocab_size"])).all()),
                "generated tokens out of vocabulary")
        require(launches == L * n_pad, f"K8 launched {launches} times, want {L * n_pad}")
        require(ref.n == 0, f"the reference ran {ref.n} times on the card's decode path")

        # one decode step at the mean live length, profiled
        dec = _decode_model(model, GEN_PROMPT + n_pad, DECODE_BLOCK, quant)
        step = _decode_step_fn(torch, dec, prompt, GEN_PROMPT + n_pad // 2)
        step()
        res["profile"] = kernel_breakdown(step, DECODE_GROUPS)

        # teacher forcing: the first two blocks through K8 and through the
        # reference on the same tokens
        feed = out[:, GEN_PROMPT:GEN_PROMPT + 2 * DECODE_BLOCK]
        with torch.no_grad():
            lk = _teacher_forced_logits(torch, dec, prompt, feed, 2)
            tr.decode_attention_step = da.decode_attention_reference
            try:
                lr = _teacher_forced_logits(torch, dec, prompt, feed, 2)
            finally:
                tr.decode_attention_step = da.decode_attention_step
        rel = float((lk - lr).norm() / lr.norm())
        agree = int((lk.argmax(-1) == lr.argmax(-1)).sum())
        res["teacher_forced"] = {"steps": 2 * DECODE_BLOCK, "rel_l2": rel,
                                 "max_abs": float((lk - lr).abs().max()),
                                 "greedy_agree": agree, "of": int(lk.shape[0] * lk.shape[1]),
                                 "bound_rel_l2": TEACHER_TOL}
        require(rel <= TEACHER_TOL,
                f"{name}: teacher-forced logits differ by {rel} (relative L2) > {TEACHER_TOL}")
        runs[name] = res
        del dec, step
    emit({"phase": "generate_gpt2_small", "config": GPT2_DECODE, "batch": GEN_BATCH,
          "prompt": GEN_PROMPT, "new_tokens": GEN_NEW, "padded_steps": n_pad, **runs})
    return runs["bfloat16"]["k8_launches"]


# ------------------------------------------------------------------ phase 9

def phase_serving(torch):
    import functools

    import numpy as np

    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.serving.engine import ServingEngine
    from distributed_ml_pytorch_tpu_torch.serving.frontend import (
        ServingClient,
        ServingFrontend,
    )
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    vocab = GPT2_DECODE["vocab_size"]
    model = TransformerLM(**GPT2_DECODE, max_len=512, dtype=torch.bfloat16,
                          pos_encoding="learned", seed=1, device="cuda")
    engine = ServingEngine(model, slots=8, cache_size=512, decode_block=16,
                           prefill_bucket=16, max_queue=64)
    warm = engine.submit(np.arange(16), 17)  # cuBLAS handles, the first prefill
    engine.run_until_idle()
    require(warm.done, "warm-up request did not finish")
    engine.reset_metrics()
    rng = np.random.default_rng(9)
    reqs = []
    for i in range(SERVE_REQUESTS):
        prompt = rng.integers(0, vocab, size=int(rng.integers(16, 129)))
        new = int(rng.integers(32, 129))
        kw = dict(temperature=0.8, top_k=40, top_p=0.95, seed=i) if i % 2 else {}
        reqs.append((prompt, new, kw))
    world = InProcessTransport.create_world(2)
    frontend = ServingFrontend(engine, world[0])
    client = ServingClient(world[1])
    server = threading.Thread(target=frontend.serve_forever, daemon=True)
    # the split count of every K8 call the engine makes, and a copy of the
    # inputs of its first call at the longest big cache it passed
    chosen, longest = {}, []
    real_splits, real_k8 = da.decode_splits, da.decode_attention_cuda

    def record_splits(bh, C, sms):
        n = real_splits(bh, C, sms)
        chosen[n] = chosen.get(n, 0) + 1
        return n

    def record_inputs(*args):
        if not longest or args[3].shape[2] > longest[0][3].shape[2]:
            longest[:] = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)]
        return real_k8(*args)

    da.decode_splits, da.decode_attention_cuda = record_splits, record_inputs
    da.launches = 0
    try:
        with _ReferenceCalls(da) as ref:
            server.start()
            t0 = time.perf_counter()
            rids = [(client.submit(p, n, **kw), n) for p, n, kw in reqs]
            streams = [(n, list(client.stream(rid, timeout=300.0))) for rid, n in rids]
            wall = time.perf_counter() - t0
    finally:
        da.decode_splits, da.decode_attention_cuda = real_splits, real_k8
        frontend.stop()
        server.join(timeout=10)
        for t in world.values():
            t.close()
    launches = da.launches
    summary = engine.slo_summary()
    n_tokens = sum(len(s) for _, s in streams)

    # K8 on the engine's own inputs at its longest cache, cold (copies in
    # turn), at every split count, each held to the reference
    args = longest[0]
    b, h, C = args[3].shape[:3]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_sets = -(-2 * L2_BYTES // _decode_bytes(args))
    sets = [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                     for _ in range(n_sets - 1)]
    want = da.decode_attention_reference(*args)
    scale = da.decode_error_scale(*args)
    engine_k8 = {"b": b, "h": h, "C": C, "live_keys": int(args[8].sum()) * h,
                 "splits": da.decode_splits(b * h, C, sms), "input_sets": n_sets,
                 "bound_ms": bound_ms(_decode_bytes(args)), "ms_by_splits": {},
                 "max_abs_err_by_splits": {}}
    for n in da.SPLITS:
        mx, rel, ok = _err(torch, da.decode_attention_cuda(*args, splits=n), want, scale,
                           DECODE_TOL["bfloat16"])
        require(ok, f"K8 on the engine's inputs at S={n}: {mx} ({rel} of the scale)")
        engine_k8["max_abs_err_by_splits"][n] = mx
        engine_k8["ms_by_splits"][n] = device_ms(_cold(sets, functools.partial(
            da.decode_attention_cuda, splits=n)), 200)
    del sets
    emit({"phase": "serving_engine", "requests": SERVE_REQUESTS, "slots": 8,
          "cache_size": 512, "decode_block": 16, "prefill_bucket": 16, "wall_s": wall,
          "tokens": n_tokens, "tokens_per_s": n_tokens / wall, "k8_launches": launches,
          "k8_splits_chosen": chosen, "k8_at_longest_cache": engine_k8,
          "reference_calls": ref.n, "slo": summary})
    require(sum(chosen.values()) == launches,
            f"K8 chose a split count {sum(chosen.values())} times in {launches} launches")
    require(C < 512, f"the engine passed K8 its whole allocation ({C} rows)")
    require(not server.is_alive(), "the serving loop did not stop")
    for i, (n, toks) in enumerate(streams):
        require(len(toks) == n and all(0 <= t < vocab for t in toks),
                f"request {i}: stream of {len(toks)} tokens (want {n}) or out of vocabulary")
    require(summary["completed"] == SERVE_REQUESTS, f"completed {summary['completed']}")
    require(launches > 0 and ref.n == 0, f"K8 launches {launches}, reference calls {ref.n}")
    return launches


# ------------------------------------------------------------------ phase 10

def phase_conv_epilogue(torch):
    import torch.nn.functional as F

    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc

    g = torch.Generator(device="cuda").manual_seed(10)
    cases = [(shape, torch.float32) for shape in BIAS_RELU_SHAPES]
    cases.append((BIAS_RELU_SHAPES[0], torch.bfloat16))
    checked = []
    errs = {"bias_relu_fwd": 0.0, "bias_relu_bwd": 0.0}
    for shape, dtype in cases:
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
        ct = torch.randn(shape, generator=g, device="cuda").to(dtype)
        x[0, ..., 0] = -b[0]  # z = 0 exactly: relu and its gradient give 0
        for bias in (None, b):
            yk = fc.bias_relu_fwd_cuda(x, bias)
            dk = fc.bias_relu_bwd_cuda(x, bias, ct)
            yp = fc.bias_relu_fwd_plain(x, bias)
            dp = fc.bias_relu_bwd_plain(x, bias, ct)
            torch.cuda.synchronize()
            what = f"{shape} {dtype} bias={bias is not None}"
            require(torch.equal(yk, yp), f"bias_relu fwd kernel != plain at {what}")
            require(torch.equal(dk, dp), f"bias_relu bwd kernel != plain at {what}")
            errs["bias_relu_fwd"] = max(errs["bias_relu_fwd"], float((yk - yp).abs().max()))
            errs["bias_relu_bwd"] = max(errs["bias_relu_bwd"], float((dk - dp).abs().max()))
            checked.append(what)

    # timed at the ladder's tail, float32 with bias, cold: input sets in
    # turn, their x alone at least twice the 50 MB L2, so each call reads its
    # inputs from device memory as the byte bound assumes; warm_ms times one
    # set that stays in L2, as right after the producing conv
    rows, c = BIAS_RELU_SHAPES[0]
    n = rows * c
    n_sets = -(-2 * L2_BYTES // (4 * n))
    b = torch.randn(c, generator=g, device="cuda")
    sets = [(torch.randn((rows, c), generator=g, device="cuda"),
             torch.randn((rows, c), generator=g, device="cuda")) for _ in range(n_sets)]
    turn = [0]

    def cold(fn):
        def call():
            turn[0] += 1
            return fn(*sets[turn[0] % n_sets])
        return call

    x, ct = sets[0]
    measured = {
        "bias_relu_fwd": {
            "max_abs_err": errs["bias_relu_fwd"],
            "ms": device_ms(cold(lambda xs, _: fc.bias_relu_fwd_cuda(xs, b))),
            "plain_ms": device_ms(cold(lambda xs, _: fc.bias_relu_fwd_plain(xs, b))),
            "library_ms": device_ms(cold(lambda xs, _: F.relu(xs))),
            "warm_ms": device_ms(lambda: fc.bias_relu_fwd_cuda(x, b)),
            "bound_ms": bound_ms(4 * (2 * n + c)), "bound_by": "bytes"},
        "bias_relu_bwd": {
            "max_abs_err": errs["bias_relu_bwd"],
            "ms": device_ms(cold(lambda xs, cs: fc.bias_relu_bwd_cuda(xs, b, cs))),
            "plain_ms": device_ms(cold(lambda xs, cs: fc.bias_relu_bwd_plain(xs, b, cs))),
            "library_ms": device_ms(cold(
                lambda xs, cs: torch.ops.aten.threshold_backward(cs, xs, 0.0))),
            "warm_ms": device_ms(lambda: fc.bias_relu_bwd_cuda(x, b, ct)),
            "bound_ms": bound_ms(4 * (3 * n + c)), "bound_by": "bytes"},
    }

    # the ladder, through the port's bench_all leg (its JSON records print
    # above this phase's line)
    for k in ("bias_relu_fwd", "bias_relu_bwd"):
        fc.launches[k] = 0
    ladder = bench_all.compute_microbench_phase("cuda")
    launches = {k: fc.launches[k] for k in ("bias_relu_fwd", "bias_relu_bwd")}
    emit({"phase": "conv_epilogue", "ok": True, "bit_identical": checked,
          "timed_shape": [rows, c], "timed": measured, "input_sets": n_sets,
          "library_note": "torch.relu(x) / aten.threshold_backward(g, x, 0) without the bias "
                          "add (one call each)",
          "ladder_us": ladder, "launches": launches})
    require(launches["bias_relu_fwd"] > 0 and launches["bias_relu_bwd"] > 0,
            f"the ladder did not launch K3: {launches}")
    return measured, launches


# ------------------------------------------------------------------ phase 11

def _head_inputs(torch, g, n, d, v, dtype, seq=None):
    """K7's inputs: bf16/f32 h2 and logits from a real h2 @ W product,
    float32 lse, random labels, gscale = mask / sum(mask) with the final
    position of every ``seq``-token sequence masked (every 7th row without
    ``seq``)."""
    w = torch.randn((v, d), generator=g, device="cuda") * 0.02
    h2 = torch.randn((n, d), generator=g, device="cuda").to(dtype)
    logits = h2 @ w.to(dtype).t()
    lse = torch.logsumexp(logits.float(), dim=-1)
    labels = torch.randint(0, v, (n,), generator=g, device="cuda")
    mask = torch.ones(n, device="cuda")
    if seq:
        mask.view(-1, seq)[:, -1] = 0.0
    else:
        mask[::7] = 0.0
    return w, h2, logits, lse, labels, mask / mask.sum()


def _head_check(torch, fh, args, dtype_name):
    """K7 against head_update_plain on one input set, from W = 0 (the result
    is -lr dW itself: the sharp check) and from the real W (the update in
    place, where most of its last bits round away against W's): (max abs
    error and max error / bound from W = 0, max error / bound from W);
    raises on a miss."""
    w, h2, logits, lse, labels, gscale = args
    dl = fh.head_dlogits(h2, logits, lse, labels, gscale)
    scale = HEAD_LR * torch.mm(dl.float().abs().t(), h2.float().abs())
    del dl
    atol, rtol = HEAD_TOL[dtype_name]
    out = []
    for w_in in (torch.zeros_like(w), w):
        wk = w_in.clone()
        fh.head_update_cuda(wk, h2, logits, lse, labels, gscale, -HEAD_LR)
        want = fh.head_update_plain(w_in, h2, logits, lse, labels, gscale, HEAD_LR)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(wk).all()),
                f"K7 not finite ({dtype_name}, {tuple(h2.shape)})")
        err = (wk - want).abs()
        ratio = float((err / (2.0 ** -23 * w_in.abs() + atol + rtol * scale)).max())
        require(ratio <= 1.0, f"K7 != plain ({dtype_name}, N, D = {tuple(h2.shape)}, V = "
                              f"{w.shape[0]}, from {'W' if out else 'zero'}): max abs err "
                              f"{float(err.max())}, err / bound {ratio}")
        out += [float(err.max()), ratio]
    return out[0], out[1], out[3]


def phase_head_update(torch):
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.ops import fused_head as fh

    full_float32()
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = {}
    # V = 677: element loads (both dtypes); V = 680: the bf16 kernel's
    # 16-byte loads with ragged N and V tiles
    for v_small, dtype in ((677, torch.float32), (677, torch.bfloat16), (680, torch.bfloat16)):
        name = str(dtype).split(".")[-1]
        args = _head_inputs(torch, g, 1000, 64, v_small, dtype)
        cases[f"ragged N1000 D64 V{v_small} {name}"] = _head_check(torch, fh, args, name)
    n, d, v = GPT2_HEAD
    args = _head_inputs(torch, g, n, d, v, torch.bfloat16, seq=2048)
    cases["GPT-2-small b8x2048 bfloat16"] = _head_check(torch, fh, args, "bfloat16")

    # timed at GPT-2-small b8 x 2048; the 1.65 GB of logits exceed the L2, so
    # every call is cold
    w, h2, logits, lse, labels, gscale = args
    wbuf = w.clone()
    dlt = fh.head_dlogits(h2, logits, lse, labels, gscale).t()

    def peak_gb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    kern = lambda: fh.head_update_cuda(wbuf, h2, logits, lse, labels, gscale, -HEAD_LR)
    plain = lambda: fh.head_update_plain(w, h2, logits, lse, labels, gscale, HEAD_LR)
    flop_ms = 2.0 * n * d * v / BF16_FLOPS * 1e3
    byte_ms = bound_ms(2 * n * v + 2 * n * d + 2 * 4 * v * d + n * (4 + 4 + 8))
    timed = {
        "max_abs_err": max(c[0] for c in cases.values()),
        "ms": device_ms(kern, 10),
        "plain_ms": device_ms(plain, 5),
        "library_ms": device_ms(lambda: torch.mm(dlt, h2, out_dtype=torch.float32), 10),
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
        "extra_peak_gb": {"kernel": peak_gb(kern), "plain": peak_gb(plain)},
    }
    emit({"phase": "head_update_vs_plain", "ok": True, "tolerance": HEAD_TOL, "lr": HEAD_LR,
          "cases": {k: {"max_abs_err": e, "max_err_over_bound": r, "from_w_err_over_bound": rw}
                    for k, (e, r, rw) in cases.items()},
          "timed_shape": {"N": n, "D": d, "V": v, "dtype": "bfloat16"}, "timed": timed,
          "library_note": "plain_ms: head_update_plain, which is the default formulation "
                          "(elementwise dl, one cuBLAS mm, the update); library_ms: the mm "
                          "alone, dl precomputed"})
    return {"fused_head": timed}


# ------------------------------------------------------------------ phase 12

def _rel_l2(torch, a, b):
    num = sum(float(((x - y).float() ** 2).sum()) for x, y in zip(a, b)) ** 0.5
    den = sum(float((y.float() ** 2).sum()) for y in b) ** 0.5
    return num / den


def phase_fused_head_step(torch):
    import numpy as np

    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.ops import fused_head as fh
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
        create_lm_train_state,
        next_token_targets,
    )
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    # config 6's legs through the port's bench_all (JSON records above)
    rates = bench_all.lm_phase("cuda")
    legs = {m: {"tokens_per_s": float(r), "step_ms": r.step_seconds * 1e3, "mfu_bf16": r.mfu,
                "tflops": r.tflops, "step": r.step_kind} for m, r in rates.items()}

    model = TransformerLM(**bench_all.GPT2_SMALL, dtype=torch.bfloat16, pos_encoding="rope",
                          seed=0, device="cuda")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, model.vocab_size, size=(8, 2048)).astype(np.int64)
    tok = torch.from_numpy(tokens).cuda()
    tgt = torch.from_numpy(next_token_targets(tokens)).cuda()
    params = list(model.parameters())
    w0 = [p.detach().clone() for p in params]
    steps = {"default": fh.make_fused_head_sgd_step(model, LM_LR),
             "k7": fh.make_fused_head_sgd_step(model, LM_LR, use_kernel=True),
             "ad": make_fsdp_lm_train_step(model, SGD(LM_LR))}
    state = create_lm_train_state(model, SGD(LM_LR))
    runs = {}
    for kind, step in steps.items():
        with torch.no_grad():
            for p, w in zip(params, w0):
                p.copy_(w)
        _zero_attention_launches(at)
        fh.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _state, loss = step(state, tok, tgt)
        torch.cuda.synchronize()
        runs[kind] = {"loss": float(loss), "update": [p.detach() - w for p, w in zip(params, w0)],
                      "launches": {"fused_head": fh.launches, **at.launches},
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    head = [i for i, (name, _) in enumerate(model.named_parameters()) if name == "lm_head.weight"]
    upd = {k: r.pop("update") for k, r in runs.items()}
    cmp = {
        "k7_vs_default": {"rel_update_l2": _rel_l2(torch, upd["k7"], upd["default"]),
                          "lm_head_rel_l2": _rel_l2(torch, [upd["k7"][i] for i in head],
                                                    [upd["default"][i] for i in head])},
        "ad_vs_default": {"rel_update_l2": _rel_l2(torch, upd["ad"], upd["default"]),
                          "rel_loss": abs(runs["ad"]["loss"] - runs["default"]["loss"])
                          / abs(runs["default"]["loss"])},
    }
    del upd

    # step time: one warm-up step and three timed steps of each
    for kind, step in steps.items():
        step(state, tok, tgt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, tok, tgt)
        torch.cuda.synchronize()
        runs[kind]["step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    profile = kernel_breakdown(lambda: steps["k7"](state, tok, tgt), PROFILE_GROUPS)
    emit({"phase": "fused_head_step_gpt2_small", "lr": LM_LR, "batch": 8, "seq": 2048,
          "bench_all_legs": legs, "steps": runs, "compare": cmp,
          "tolerance": {"fused_head_update": FUSED_HEAD_UPDATE_TOL, "ad_loss": AD_LOSS_TOL,
                        "ad_update": AD_UPDATE_TOL},
          "k7_step_profile": profile})
    n_layers = model.n_layers
    for kind, r in runs.items():
        la = r["launches"]
        require(la["fused_head"] == (1 if kind == "k7" else 0),
                f"{kind} step launched K7 {la['fused_head']} times")
        require(la["flash_fwd"] == n_layers and la["flash_bwd_fused"] == n_layers,
                f"{kind} step launched K4/K5 {la}")
    require(runs["k7"]["loss"] == runs["default"]["loss"],
            f"K7 step loss {runs['k7']['loss']} != default {runs['default']['loss']}")
    require(cmp["k7_vs_default"]["rel_update_l2"] <= FUSED_HEAD_UPDATE_TOL,
            f"K7 and default updates differ: {cmp['k7_vs_default']}")
    require(cmp["ad_vs_default"]["rel_loss"] <= AD_LOSS_TOL
            and cmp["ad_vs_default"]["rel_update_l2"] <= AD_UPDATE_TOL,
            f"AD and fused-head steps differ: {cmp['ad_vs_default']}")
    for m in ("gpt2_small_seq2048_train_throughput", "gpt2_small_seq8192_train_throughput"):
        require(legs[m]["tokens_per_s"] > 0 and legs[m]["mfu_bf16"] is not None,
                f"{m}: {legs[m]}")
    return runs["k7"]["launches"]["fused_head"]


# ------------------------------------------------------------------ main

K4_SRC = "distributed_ml_pytorch_tpu_torch/csrc/flash_fwd_tc.cu"
K5_SRC = "distributed_ml_pytorch_tpu_torch/csrc/flash_bwd_tc.cu"
KERNEL_ROWS = [
    ("flat_axpy", "distributed_ml_pytorch_tpu_torch/csrc/fused_update.cu",
     "distributed_ml_pytorch_tpu/ops/fused_update.py:57"),
    ("relu_pool2_fwd", "distributed_ml_pytorch_tpu_torch/csrc/fused_conv.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:321"),
    ("relu_pool2_bwd", "distributed_ml_pytorch_tpu_torch/csrc/fused_conv.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:311"),
    ("flash_fwd", K4_SRC, "distributed_ml_pytorch_tpu/ops/attention.py:311"),
    ("flash_bwd_fused", K5_SRC, "distributed_ml_pytorch_tpu/ops/attention.py:563"),
    ("flash_bwd_dq", K5_SRC, "distributed_ml_pytorch_tpu/ops/attention.py:592"),
    ("flash_bwd_dkv", K5_SRC, "distributed_ml_pytorch_tpu/ops/attention.py:605"),
    ("decode_attention", "distributed_ml_pytorch_tpu_torch/csrc/decode_attention.cu",
     "distributed_ml_pytorch_tpu/ops/decode_attention.py:128"),
    ("fused_head", "distributed_ml_pytorch_tpu_torch/csrc/fused_head.cu",
     "distributed_ml_pytorch_tpu/ops/fused_head.py:105"),
    ("bias_relu_fwd", "distributed_ml_pytorch_tpu_torch/csrc/bias_relu.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:177"),
    ("bias_relu_bwd", "distributed_ml_pytorch_tpu_torch/csrc/bias_relu.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:177"),
]


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAILED: torch unavailable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        import distributed_ml_pytorch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAILED: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    try:
        phase_device_and_build(torch)
        measured = phase_kernels(torch)
        phase_trainer(torch)
        launches = phase_downpour(torch)
        measured.update(phase_attention(torch))
        lm_launches, split_launches = phase_lm(torch)
        # K4/K5 from the LM run; K6a/K6b from the split step, the model path
        # that runs them
        launches.update({k: lm_launches[k] for k in ("flash_fwd", "flash_bwd_fused")})
        launches.update({k: split_launches[k] for k in ("flash_bwd_dq", "flash_bwd_dkv")})
        phase_default_widths(torch)
        measured.update(phase_decode_attention(torch))
        launches["decode_attention"] = phase_generate(torch)
        phase_serving(torch)
        k3, k3_launches = phase_conv_epilogue(torch)
        measured.update(k3)
        launches.update(k3_launches)
        measured.update(phase_head_update(torch))
        launches["fused_head"] = phase_fused_head_step(torch)
        smi = nvidia_smi_line()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, source, replaces in KERNEL_ROWS:
        m = measured[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m.get("bound_by", "bytes"),
                        "library_ms": m["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
