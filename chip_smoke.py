#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device and build: the card's name, count and power limit, and the nvcc
   build of ``distributed_ml_pytorch_tpu_torch/csrc/*.cu``; then the
   ``-Xptxas -v`` lines (registers, spills) of K2, the tensor-core K4, of
   K5, K6a and K6b, of K8 and of K7, each source on a line of its own;
2. every kernel against its plain PyTorch version on the card, at the shapes
   of the main path, bit-identical: flat_axpy at AlexNet's padded length;
   relu_pool2 forward and backward at AlexNet's three epilogue shapes at
   batch 64 and 1024 (with and without bias, ties forced or not) on the
   vector route, and at an odd C and a misaligned contiguous view on the
   scalar route, each route read from the per-route launch counts; with the
   kernel's, the plain version's and one library call's time (CUDA events,
   the launches queued behind a busy wait so the card runs them back to
   back) and the byte bound at 3.35 TB/s; relu_pool2 per shape cold (input
   sets in turn, twice the L2) and warm at both batches, beside the launch
   floor (a one-element ``add_``) and the host µs of a forward+backward call
   at batch 64;
3. trainer steps of AlexNet(fused_epilogue=True) against the same steps of
   fused_epilogue=False (cuDNN deterministic, full float32) at batch 64 and
   1024: equal losses and parameters, K2 three times a step each way, all on
   the vector route;
4. the DownPour path: a parameter server and two workers in one process
   (threads, in-process transport) through ``run_server``/``train_worker``
   with the CLI defaults (AlexNet, batch 64, lr 0.008, n_push = n_pull = 10)
   and ``--chunked-dispatch off`` (one eager step a dispatch) on synthetic
   CIFAR-10; the kernels' launch counts are zeroed just before and read just
   after, every kernel must have run and ``flat_axpy`` once a step; each
   worker's steps/s from its record 5 on (as before phase 15 existed) and
   its steady steps/s over the window phase 15 reads too;
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
   product, float32 lse, random labels, gscale = mask / sum(mask)) and at
   ``HEAD_SMALL``'s ragged shapes (the float32 kernel, the bf16 element
   loads at V 677, the bf16 TMA route at D 64, 768 and 1024 and at N 20),
   from W = 0 and from W, within ``HEAD_TOL``, each case's route read from
   the per-route launch counts; two launches of the TMA route at
   GPT-2-small bit-identical; timed beside the plain version (the default
   formulation), the product alone and the FLOP bound, with peak memory;
12. the restructured-head GPT-2-small step: ``bench_all.lm_phase`` (config
   6's three legs: tokens/s and MFU), then one step each of
   ``make_fused_head_sgd_step`` with ``use_kernel`` False and True and of the
   AD step ``make_fsdp_lm_train_step`` from the same weights: K7 once per
   ``use_kernel=True`` step, by its TMA route, and never otherwise, K4 and
   K5 12 times each;
   equal losses between the two fused steps and updates within
   ``FUSED_HEAD_UPDATE_TOL``; the AD step within ``AD_LOSS_TOL`` and
   ``AD_UPDATE_TOL``; step ms and peak memory of the three, and one
   profiled ``use_kernel=True`` step;
13. config 1's AlexNet legs through ``bench_all.alexnet_phase`` under
   cuDNN's default algorithm choice, K steps a dispatch as the JAX harness
   runs them (a CUDA graph of one step replayed: batch 64 unfused at 100,
   batch 1024 fused and unfused at 20, and batch 1024 as microbatch-256
   accumulation at 20 updates; images/s and the share of the float32
   peak), then one profiled
   fused step each of the DownPour worker at batch 64 (K1 once) and the
   trainer at batch 1024: K2a and K2b 3 times each on the vector route,
   in the profile and in the wrappers' counts, no launch whose kernel the
   profiler lost, device ms by group and the idle gap before each group's
   launches; then
   the batch-1024 fused step timed under cuDNN's default, deterministic and
   benchmark (autotuned) algorithm choices;
14. the trainer family, under deterministic cuDNN: (a) K2 in bfloat16
   bit-identical to its plain versions at AlexNet's three tails at batch 64
   and 1024 (bias or none, ties forced or not) on the 8-channel vector
   route, and at C 36, an odd C and a misaligned view on the scalar route,
   each route read from the per-route bfloat16 counts; timed cold and warm
   beside the plain versions, ``max_pool2d(relu)`` in bfloat16 and the
   halved byte bound; then AlexNet fused in bfloat16 at batch 1024, 5
   steps a dispatch graphed under cuDNN's default algorithms, timed and one
   dispatch profiled (K2's bfloat16 kernels 3 a step), and one graphed
   dispatch of 2 ``grad_accum_b1024`` updates profiled; (b)
   ``make_scan_train_step`` as a CUDA graph at
   AlexNet fused batch 64, 100 steps a dispatch, against 100 eager steps
   from the same weights: equal losses and parameters; each way's wall
   time a step; one graphed dispatch profiled (K2a/K2b 3 a step, no launch
   lost, the idle share) beside ten eager steps; (c) the
   ``grad_accum_b1024`` update graphed (two dispatches of 2) against four
   eager updates: equal; (d) ``train_single`` through ``training/cli.main``
   on synthetic data (bfloat16, 10 steps a dispatch, accumulation 2, adamw,
   cosine, clipping) run to the end under the profiler (K2's bfloat16
   kernels in it, the vector route in the wrappers' counts), then stopped
   after its step-15 checkpoint and resumed with ``--resume``: the final
   checkpoints and the CSV losses equal;
15. the chunked DownPour worker, under deterministic cuDNN in full float32
   (AlexNet fused, batch 64, n_push = n_pull = 10): (a) one worker chunked
   (each run of 1 or 9 local steps one dispatch of a captured CUDA graph)
   against one per step (eager) from the same weights on the same batches,
   60 steps, against a transport that never replies: every push and the
   final parameters bit for bit, one capture for both run lengths; a
   second 60 steps of each timed (wall ms a step); (b) one 9-step run
   of the chunked worker after the capture profiled (``utils/devprof``: K1
   9 times, K2a and K2b 27 times each among the replay's kernels, no launch
   lost; busy ms a step, idle share), and the boundary's parts timed: the
   install of a 9.9 MB central vector and a snapshot plus push; (c) phase
   4's world with ``--chunked-dispatch on --ckpt-dir build/smoke_ps --wal
   --admission``: each worker's loss falls, the server counts the pushes and
   pulls, nothing is quarantined, the wrappers count each worker's two
   warm-up steps and its capture; steady steps/s beside phase 4's; (d) a
   fresh server restores ``build/smoke_ps`` to (c)'s final central vector,
   ``apply_seq`` and version, bit for bit;
16. the DownPour world as processes on the card, under deterministic cuDNN
   in full float32: (a) one server process and two worker processes over
   TCP on a free port, each started from a short inline script that calls
   ``run_ps_process`` (the CLI's entry) and prints one JSON line, with
   phase 15 (c)'s recipe (AlexNet fused, batch 64, lr 0.008, n_push =
   n_pull = 10, 80 steps a worker on synthetic data, ``--chunked-dispatch
   on``) and every plane on: ``--transport native --reliable --wal
   --admission --ckpt-dir build/smoke_ps_mp``. Each worker's loss falls;
   the server's applied pushes equal the workers' pushes sent and acked;
   nothing given up, dropped on the checksum or quarantined; each worker's
   wrappers count its two warm-up steps and one capture (K1 and K2 run in
   its graph); the native library loaded. Each worker's steady steps/s
   over phase 15 (c)'s window beside 15 (c)'s, and its retries, duplicates
   dropped and window-blocked count and seconds, and every rank's final
   timeout per peer; (b) the same world on the plain wire (``--transport
   python``, no ``--reliable``), the same checks without the acks; (e)
   ``--transport native`` without ``--reliable`` and (f) ``--transport
   python --reliable``, each with its world's checks, so that the four part
   the transport's share of the rate from the reliable layer's (they run
   after (b), before (c)); (c) a fresh server restores ``build/smoke_ps_mp`` to
   (a)'s final central vector, ``apply_seq`` and version bit for bit and
   seeds its transport's dedup from the envelopes of (a)'s applies; (d)
   ``bench_all --legs ps`` (config 3: one server and four worker
   processes, then a server and a chunked worker process against single
   mode), its lines printed.

Then the ``kernels`` line, the ``nvidia-smi`` name/power line, and last the
result line ``{"ok": true, "device": {...}}``. Without a card, or without
the package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
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

#: seconds after which a hung run dumps its threads' stacks and exits 1
#: (the run must finish within 1200 s, the kernels' build included)
WATCHDOG_S = 1100
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
BF16_FLOPS = 989.4e12      # H100 SXM dense bf16 tensor cores, NVIDIA's data sheet
L2_BYTES = 50 * 2**20      # H100 L2 cache
ALEXNET_PADDED = 2_472_320
#: K2's bit-identity cases, (shape, misaligned, route): AlexNet's three
#: relu->pool tails at the DownPour batch and config 1's batch 1024 (vector
#: route), an odd C and a contiguous view one element into its storage
#: (scalar route)
POOL_CASES = ([((b, h, w, c), False, "vector") for b in (64, 1024)
               for h, w, c in ((8, 8, 64), (4, 4, 192), (2, 2, 256))]
              + [((64, 4, 4, 37), False, "scalar"), ((64, 8, 8, 64), True, "scalar")])
#: AlexNet's relu->pool tails (H, W, C), the conv1, conv2 and conv5
#: outputs, timed at the DownPour batch and config 1's batch 1024
POOL_TAILS = ((8, 8, 64), (4, 4, 192), (2, 2, 256))
POOL_BATCHES = (64, 1024)
#: kernel-name substrings grouping an AlexNet step's device time (first
#: match wins): cuDNN's and PyTorch's convolution kernels by pass
ALEXNET_GROUPS = {
    "K2a relu_pool2_fwd": ["relu_pool2_fwd"],
    "K2b relu_pool2_bwd": ["relu_pool2_bwd"],
    "K1 flat_axpy": ["flat_axpy"],
    "conv wgrad": ["wgrad"],
    "conv dgrad": ["dgrad"],
    "conv fwd": ["fprop", "convolve", "conv2d", "implicit_gemm"],
}
WORKER_STEPS = 80
#: a DownPour worker's steady window opens at the first host read of its
#: losses at or after step STEADY_FROM - 1 (see _steady_record)
STEADY_FROM = 10
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
#: K7's small cases, (N, D, V, dtype): see phase_head_update
HEAD_SMALL = [(1000, 64, 677, "float32"), (1000, 64, 677, "bfloat16"),
              (1000, 64, 680, "bfloat16"), (1000, 768, 680, "bfloat16"),
              (1000, 1024, 680, "bfloat16"), (20, 768, 64, "bfloat16")]
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
    for src in ("fused_conv", "flash_fwd_tc", "flash_bwd_tc", "decode_attention",
                "fused_head"):
        emit({"phase": f"{src}_ptxas", "lines": [
            ln.strip() for ln in _build.build_logs(src).splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]})


# ------------------------------------------------------------------ phase 2

def phase_kernels(torch):
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

    out.update(_relu_pool2_checks(torch, g))
    pool_line = out.pop("pool_line")
    emit({"phase": "kernels_vs_plain", "ok": True, **out, **pool_line})
    return out


def _pool_bytes(shape, elem_bytes: int = 4) -> dict:
    """Bytes K2 must move at NHWC ``shape`` without bias: the forward reads
    x and writes m (a quarter of x); the backward reads x, m and g and
    writes dx."""
    x = elem_bytes * math.prod(shape)
    return {"fwd": x + x // 4, "bwd": 2 * x + 2 * (x // 4)}


def _pool_input_sets(torch, fc, shape, g, dtype=None):
    """``(x, m, g)`` sets at NHWC ``shape`` (float32 unless ``dtype``),
    enough that their x alone is at least twice the L2, so a call that takes
    them in turn reads its inputs from device memory."""
    dtype = dtype or torch.float32
    elem = torch.finfo(dtype).bits // 8
    n = max(2, -(-2 * L2_BYTES // (elem * math.prod(shape))))
    pooled = (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    sets = []
    for _ in range(n):
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        sets.append((x, fc.relu_pool2_fwd_plain(x),
                     torch.randn(pooled, generator=g, device="cuda").to(dtype)))
    return sets


def _time_pool_shape(torch, fc, shape, g, dtype=None) -> dict:
    """Device ms of K2a/K2b at NHWC ``shape`` (no bias: AlexNet keeps its
    bias in the conv), cold (input sets in turn) and warm (one set,
    L2-resident as right after the producing conv), beside the byte bound,
    the plain versions and ``max_pool2d(relu)``, cold; float32 unless
    ``dtype``."""
    F = torch.nn.functional
    sets = _pool_input_sets(torch, fc, shape, g, dtype)
    x, m, gr = sets[0]
    nbytes = _pool_bytes(shape, x.element_size())
    return {
        "shape": list(shape), "input_sets": len(sets),
        "fwd_ms": device_ms(_cold(sets, lambda xs, ms, gs: fc.relu_pool2_fwd_cuda(xs))),
        "bwd_ms": device_ms(_cold(
            sets, lambda xs, ms, gs: fc.relu_pool2_bwd_cuda(xs, None, ms, gs))),
        "fwd_warm_ms": device_ms(lambda: fc.relu_pool2_fwd_cuda(x)),
        "bwd_warm_ms": device_ms(lambda: fc.relu_pool2_bwd_cuda(x, None, m, gr)),
        "fwd_bound_ms": bound_ms(nbytes["fwd"]), "bwd_bound_ms": bound_ms(nbytes["bwd"]),
        "fwd_plain_ms": device_ms(
            _cold(sets, lambda xs, ms, gs: fc.relu_pool2_fwd_plain(xs)), 20),
        "bwd_plain_ms": device_ms(
            _cold(sets, lambda xs, ms, gs: fc.relu_pool2_bwd_plain(xs, None, ms, gs)), 20),
        # one library call on the channels_last NCHW view, as the model holds it
        "fwd_library_ms": device_ms(_cold(
            sets, lambda xs, ms, gs: F.max_pool2d(F.relu(xs.permute(0, 3, 1, 2)), 2))),
    }


def _host_us(torch, fn, iters: int = 200) -> float:
    """Host µs a call: wall time over ``iters`` calls with one synchronise at
    the end, after 5 warm-up calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def _pool_host_costs(torch, fc, x, g) -> dict:
    """Host and device µs of one ``relu_pool2`` forward+backward at ``x``'s
    shape: through autograd (as a model's step calls it), through the two
    wrappers alone, and the unfused plain chain through autograd."""
    F = torch.nn.functional

    def autograd():
        v = x.detach().requires_grad_(True)
        return torch.autograd.grad(fc.relu_pool2(v), v, g)[0]

    def wrappers():
        return fc.relu_pool2_bwd_cuda(x, None, fc.relu_pool2_fwd_cuda(x), g)

    def unfused():
        v = x.detach().requires_grad_(True)
        return torch.autograd.grad(fc.max_pool_2x2(F.relu(v)), v, g)[0]

    out = {"shape": list(x.shape)}
    for name, fn in (("autograd", autograd), ("wrappers", wrappers),
                     ("unfused_autograd", unfused)):
        out[name] = {"host_us": _host_us(torch, fn), "device_us": 1e3 * device_ms(fn)}
    return out


def _relu_pool2_checks(torch, g):
    """K2a/K2b bit-identical to the plain versions at POOL_CASES (bias or
    none, ties forced or not), each on the route the rule names; then timed
    per shape cold and warm at both batches beside the launch floor, and
    the host cost of a forward+backward call at batch 64."""
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc

    dev = torch.device("cuda")
    err = {"fwd": 0.0, "bwd": 0.0}
    held = []
    for shape, misaligned, want in POOL_CASES:
        nb, h, w, c = shape
        xr = torch.randn(shape, generator=g, device=dev)
        # forced ties: half-step values repeat inside windows, and windows of
        # negatives all tie at 0 after relu
        xt = torch.round(xr * 2) / 2
        gr = torch.randn((nb, h // 2, w // 2, c), generator=g, device=dev)
        before = dict(fc.launches)
        for xin in (xr, xt):
            if misaligned:  # a contiguous view one element into its storage
                xin = torch.empty(xin.numel() + 1, device=dev)[1:].view(shape).copy_(xin)
            for bias in (None, torch.randn(c, generator=g, device=dev)):
                mk = fc.relu_pool2_fwd_cuda(xin, bias)
                mp = fc.relu_pool2_fwd_plain(xin, bias)
                dk = fc.relu_pool2_bwd_cuda(xin, bias, mk, gr)
                dp = fc.relu_pool2_bwd_plain(xin, bias, mp, gr)
                torch.cuda.synchronize()
                what = f"{shape} misaligned={misaligned} bias={bias is not None}"
                require(torch.equal(mk, mp), f"relu_pool2 fwd kernel != plain at {what}")
                require(torch.equal(dk, dp), f"relu_pool2 bwd kernel != plain at {what}")
                err["fwd"] = max(err["fwd"], float((mk - mp).abs().max()))
                err["bwd"] = max(err["bwd"], float((dk - dp).abs().max()))
        ran = {k: fc.launches[k] - before[k] for k in fc.launches if k.startswith("relu_pool2")}
        require(ran[f"relu_pool2_fwd.{want}"] == 4 and ran[f"relu_pool2_bwd.{want}"] == 4
                and ran["relu_pool2_fwd"] == 4 and ran["relu_pool2_bwd"] == 4,
                f"relu_pool2 at {shape} (misaligned={misaligned}) ran {ran}, not the {want} "
                f"route")
        held.append({"shape": list(shape), "misaligned": misaligned, "route": want})

    # the launch floor: a one-element add_ by the same timer
    one, two = torch.zeros(1, device=dev), torch.ones(1, device=dev)
    floor = device_ms(lambda: one.add_(two))
    rows = {b: [_time_pool_shape(torch, fc, (b, *t), g) for t in POOL_TAILS]
            for b in POOL_BATCHES}
    x = torch.randn((64, *POOL_TAILS[0]), generator=g, device=dev)
    gx = torch.randn((64, 4, 4, POOL_TAILS[0][2]), generator=g, device=dev)
    host = _pool_host_costs(torch, fc, x, gx)

    def total(batch, key):
        return sum(r[key] for r in rows[batch])

    # the kernels line: the batch-1024 sums of the three tails, cold
    measured = {}
    for k, name in (("fwd", "relu_pool2_fwd"), ("bwd", "relu_pool2_bwd")):
        measured[name] = {
            "max_abs_err": err[k], "ms": total(1024, f"{k}_ms"),
            "plain_ms": total(1024, f"{k}_plain_ms"),
            "library_ms": total(1024, "fwd_library_ms") if k == "fwd" else None,
            "bound_ms": total(1024, f"{k}_bound_ms"), "bound_by": "bytes"}
    measured["pool_line"] = {
        "relu_pool2": {
            "held": held, "launch_floor_ms": floor, "host_fwd_bwd_b64": host,
            "b1024_cold_sum_ms": {k: total(1024, f"{k}_ms") for k in ("fwd", "bwd")},
            "b1024_bound_sum_ms": {k: total(1024, f"{k}_bound_ms") for k in ("fwd", "bwd")},
            "b64_warm_sum_ms": {k: total(64, f"{k}_warm_ms") for k in ("fwd", "bwd")},
            "b64_cold_sum_ms": {k: total(64, f"{k}_ms") for k in ("fwd", "bwd")},
            "note": "kernels-line K2 rows are the batch-1024 cold sums; b64_warm_sum_ms "
                    "continues the batch-64 sums of earlier runs; library: "
                    "max_pool2d(relu) on the channels_last view (cold)"},
        "pool_shapes": rows[64] + rows[1024]}
    return measured


# ------------------------------------------------------------------ phase 3

def phase_trainer(torch, device="cuda", steps=5, batch=64):
    from distributed_ml_pytorch_tpu_torch.data import load_cifar10
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        SGD,
        create_train_state,
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
        state = create_train_state(model, SGD(0.008))
        step = make_train_step(model, SGD(0.008))
        before = dict(fc.launches)
        losses = [float(step(state, *to_device(x[i * batch:(i + 1) * batch],
                                               y[i * batch:(i + 1) * batch], device))[1])
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
        require(all(kf[f"relu_pool2_{d}{route}"] == 3 * steps
                    for d in ("fwd", "bwd") for route in ("", ".vector")),
                f"fused trainer steps launched the K2 kernels {kf} times, not 3 a step "
                f"each on the vector route")


# ------------------------------------------------------------------ phase 4

def _downpour_world(torch, argv, device="cuda", steps=WORKER_STEPS, batch=64):
    """A parameter server and two workers as threads of this process on the
    in-process transport, through ``run_server``/``train_worker`` with the
    CLI defaults (AlexNet, batch 64, lr 0.008, n_push = n_pull = 10) plus
    ``argv``, on synthetic CIFAR-10; the kernels' launch counts are zeroed
    just before and read just after. Returns ``(server, per_worker,
    launches, wall_s, records)``; a worker's steady rate runs from its
    record :func:`_steady_record` to its last."""
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
    from distributed_ml_pytorch_tpu_torch.training.cli import build_parser
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    args = build_parser().parse_args([
        "--epochs", "1", "--synthetic-data",
        "--synthetic-train-size", str(steps * batch), "--synthetic-test-size", "512",
        "--batch-size", str(batch), "--log-interval", str(10 * steps),
        "--worker-timeout", "0", "--log-dir", os.path.join(ROOT, "build", "smoke_runs"),
        *argv])
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
    server = threading.Thread(target=guard, daemon=True, args=(
        "server", lambda: tps.run_server(args, world[0])))
    workers = [threading.Thread(target=guard, daemon=True, args=(
        r, lambda r=r: tps.train_worker(args, world[r], device=device))) for r in (1, 2)]
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
    per_worker = {}
    s = _steady_record(steps)
    for r in (1, 2):
        _model, logger = results[r]
        recs = logger.records
        losses = [rec["training_loss"] for rec in recs]
        steady = (len(recs) - 1 - s) / (recs[-1]["timestamp"]
                                        - recs[s]["timestamp"]).total_seconds()
        per_worker[r] = {"steps": len(recs), "early_loss": sum(losses[:10]) / 10,
                         "late_loss": sum(losses[-10:]) / 10, "steady_from_step": s + 1,
                         "steady_steps_per_s": steady, "steady_images_per_s": steady * batch}
    records = {r: results[r][1].records for r in (1, 2)}
    return results["server"], per_worker, launches, wall, records


def _steady_record(steps):
    """The record that opens a DownPour worker's steady window, the same in
    both dispatch modes: the last of the chunked worker's first loss read
    (every ``LOSS_FLUSH_DISPATCHES`` dispatches) that ends at or after step
    ``STEADY_FROM - 1``. A per-step record and the last record of each read
    are logged just after the host read its step's loss, so the window runs
    between two moments at which the card had finished every step before
    them; nothing in the workers is patched or synchronised for it."""
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps

    k = tps.LOSS_FLUSH_DISPATCHES
    ends = [g + n for g, n in tps.downpour_chunk_schedule(10, 10, 0, steps)[k - 1::k]]
    s = next((e for e in ends if e >= STEADY_FROM), steps) - 1
    require(s < steps - 1, f"no steady window in {steps} steps")
    return s


def phase_downpour(torch, device="cuda", steps=WORKER_STEPS, batch=64):
    """Phase 4: the per-step DownPour world (``--chunked-dispatch off``)."""
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

    srv, per_worker, launches, wall, records = _downpour_world(
        torch, ["--chunked-dispatch", "off"], device, steps, batch)
    for r, recs in records.items():
        # the per-step rate as it was read before the steady window existed
        # (every record here is a host read): from record 5 to the last
        span = (recs[-1]["timestamp"] - recs[5]["timestamp"]).total_seconds()
        sps = (len(recs) - 6) / span
        per_worker[r].update(steps_per_s=sps, images_per_s=sps * batch)
    counts = {c.name: n for c, n in srv.message_counts.items() if n}
    emit({"phase": "downpour_world", "workers": 2, "batch": batch, "wall_s": wall,
          "dispatch": "per-step", "per_worker": per_worker, "server_messages": counts,
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
        # one launch a step: valid for the per-step path only (a graph's
        # replays pass no wrapper)
        require(launches["flat_axpy"] == total_steps,
                f"flat_axpy launched {launches['flat_axpy']} times for {total_steps} steps")
        require(launches["relu_pool2_fwd"] > 0 and launches["relu_pool2_bwd"] > 0,
                f"relu_pool2 kernels not launched on the main path: {launches}")
    return launches, per_worker


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
    route = fh.head_update_route(h2, logits)
    dl = fh.head_dlogits(h2, logits, lse, labels, gscale)
    scale = HEAD_LR * torch.mm(dl.float().abs().t(), h2.float().abs())
    del dl
    atol, rtol = HEAD_TOL[dtype_name]
    out = []
    for w_in in (torch.zeros_like(w), w):
        wk = w_in.clone()
        before = fh.route_launches[route]
        fh.head_update_cuda(wk, h2, logits, lse, labels, gscale, -HEAD_LR)
        want = fh.head_update_plain(w_in, h2, logits, lse, labels, gscale, HEAD_LR)
        torch.cuda.synchronize()
        require(fh.route_launches[route] == before + 1, f"K7 did not take route {route}")
        require(bool(torch.isfinite(wk).all()),
                f"K7 not finite ({dtype_name}, {tuple(h2.shape)})")
        err = (wk - want).abs()
        ratio = float((err / (2.0 ** -23 * w_in.abs() + atol + rtol * scale)).max())
        require(ratio <= 1.0, f"K7 != plain ({dtype_name}, {route}, N, D = "
                              f"{tuple(h2.shape)}, V = {w.shape[0]}, from "
                              f"{'W' if out else 'zero'}): max abs err {float(err.max())}, "
                              f"err / bound {ratio}")
        out += [float(err.max()), ratio]
    return route, out[0], out[1], out[3]


def phase_head_update(torch):
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.ops import fused_head as fh

    full_float32()
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = {}
    # V = 677: the float32 kernel and the bf16 element loads; V % 8 == 0: the
    # bf16 TMA route with ragged N and V tiles, at D 64 (one consumer
    # warpgroup, its columns masked), 768 (three), 1024 (two passes over D)
    # and N 20 (less than one stage)
    for n_small, d_small, v_small, dtype in HEAD_SMALL:
        name = str(dtype).split(".")[-1]
        args = _head_inputs(torch, g, n_small, d_small, v_small, getattr(torch, dtype))
        cases[f"N{n_small} D{d_small} V{v_small} {name}"] = _head_check(torch, fh, args, name)
    n, d, v = GPT2_HEAD
    args = _head_inputs(torch, g, n, d, v, torch.bfloat16, seq=2048)
    cases["GPT-2-small b8x2048 bfloat16"] = _head_check(torch, fh, args, "bfloat16")
    require(cases["GPT-2-small b8x2048 bfloat16"][0] == "bf16_tma",
            "GPT-2-small does not take K7's TMA route")

    # timed at GPT-2-small b8 x 2048; the 1.65 GB of logits exceed the L2, so
    # every call is cold
    w, h2, logits, lse, labels, gscale = args
    # two launches from the same W give the same bits (no atomics)
    twice = [w.clone(), w.clone()]
    for wk in twice:
        fh.head_update_cuda(wk, h2, logits, lse, labels, gscale, -HEAD_LR)
    torch.cuda.synchronize()
    bit_identical = torch.equal(twice[0], twice[1])
    require(bit_identical, "K7's TMA route differs between two launches")
    del twice
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
        "max_abs_err": max(c[1] for c in cases.values()),
        "ms": device_ms(kern, 10),
        "plain_ms": device_ms(plain, 5),
        "library_ms": device_ms(lambda: torch.mm(dlt, h2, out_dtype=torch.float32), 10),
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
        "extra_peak_gb": {"kernel": peak_gb(kern), "plain": peak_gb(plain)},
    }
    emit({"phase": "head_update_vs_plain", "ok": True, "tolerance": HEAD_TOL, "lr": HEAD_LR,
          "cases": {k: {"route": rt, "max_abs_err": e, "max_err_over_bound": r,
                        "from_w_err_over_bound": rw}
                    for k, (rt, e, r, rw) in cases.items()},
          "bit_identical_two_launches": bit_identical,
          "timed_shape": {"N": n, "D": d, "V": v, "dtype": "bfloat16", "route": "bf16_tma"},
          "timed": timed,
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
        fh.route_launches.update(dict.fromkeys(fh.route_launches, 0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _state, loss = step(state, tok, tgt)
        torch.cuda.synchronize()
        runs[kind] = {"loss": float(loss), "update": [p.detach() - w for p, w in zip(params, w0)],
                      "launches": {"fused_head": fh.launches,
                                   "fused_head_bf16_tma": fh.route_launches["bf16_tma"],
                                   **at.launches},
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
        want = 1 if kind == "k7" else 0
        require(la["fused_head"] == want and la["fused_head_bf16_tma"] == want,
                f"{kind} step launched K7 {la['fused_head']} times, "
                f"{la['fused_head_bf16_tma']} by its TMA route")
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


# ------------------------------------------------------------------ phase 13

def phase_alexnet(torch):
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    # the legs and profiles under cuDNN's defaults, as the trainer and the
    # DownPour worker leave them (phase 3 set deterministic algorithms)
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = torch.backends.cudnn.benchmark = False
    rates = bench_all.alexnet_phase("cuda")
    for metric, r in rates.items():
        require(math.isfinite(r) and r > 0, f"{metric}: {float(r)} images/s")
    for rec in bench_all.RESULTS:
        if rec["metric"].startswith("alexnet_"):
            require(all(math.isfinite(v) for v in rec["warmup_losses"]),
                    f"{rec['metric']}: losses {rec['warmup_losses']}")
    profiles = {}
    for name, step, k1 in (
            ("downpour_b64", bench_all.alexnet_step(64, True, "cuda", downpour=True), 1),
            ("train_b1024", bench_all.alexnet_step(1024, True, "cuda"), 0)):
        for _ in range(3):
            step()
        fu.launches = 0
        for k in fc.launches:
            fc.launches[k] = 0
        want = {"K2a relu_pool2_fwd": 3, "K2b relu_pool2_bwd": 3, "K1 flat_axpy": k1}
        prof = kernel_breakdown(step, ALEXNET_GROUPS, top=12)
        require("busy_ms" in prof and prof["lost_launches"] == 0,
                f"{name}: the profile lost kernels: {prof}")
        n = prof["group_launches"]
        require(all(n[k] == v for k, v in want.items()),
                f"{name}: profiled launches {n} (want {want})")
        # the wrappers' counts over every run of the step the profiler made
        runs = prof["runs"]
        require(fu.launches == k1 * runs
                and fc.launches["relu_pool2_fwd"] == fc.launches["relu_pool2_bwd"] == 3 * runs
                and fc.launches["relu_pool2_fwd.vector"] == 3 * runs
                and fc.launches["relu_pool2_bwd.vector"] == 3 * runs,
                f"{name}: wrapper counts {fc.launches}, flat_axpy {fu.launches} over "
                f"{runs} profiled run(s)")
        profiles[name] = {"step_ms": device_ms(step, 20), **prof}
    # the batch-1024 fused step under each cuDNN algorithm choice
    cudnn_step_ms = {}
    for label, det, bench in (("default", False, False), ("deterministic", True, False),
                              ("benchmark", False, True)):
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
        step = bench_all.alexnet_step(1024, True, "cuda")
        cudnn_step_ms[label] = device_ms(step, 20)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    emit({"phase": "alexnet", "ok": True,
          "images_per_s": {m: float(r) for m, r in rates.items()},
          "profiles": profiles, "b1024_fused_step_ms_by_cudnn_setting": cudnn_step_ms})


# ------------------------------------------------------------------ phase 14

#: K2's bfloat16 cases, (shape, misaligned, route): AlexNet's three tails at
#: both batches (vector route: C % 8 == 0), C % 8 != 0 (36) and an odd C,
#: and a contiguous view one element (2 bytes) into its storage (scalar)
POOL_CASES_BF16 = ([((b, h, w, c), False, "vector") for b in POOL_BATCHES
                    for h, w, c in POOL_TAILS]
                   + [((64, 4, 4, 36), False, "scalar"), ((64, 4, 4, 37), False, "scalar"),
                      ((64, 8, 8, 64), True, "scalar")])
#: an AlexNet trainer step's kernel groups, K2's bfloat16 kernels first
TRAINER_GROUPS = {"K2a relu_pool2_bf16_fwd": ["relu_pool2_bf16_fwd"],
                  "K2b relu_pool2_bf16_bwd": ["relu_pool2_bf16_bwd"], **ALEXNET_GROUPS}
#: steps a dispatch of the graphed batch-64 trainer (the JAX harness's SCAN_K)
SCAN_K = 100
#: (d)'s CLI run: synthetic CIFAR-10, 20 steps an epoch, two epochs; the
#: interrupted run stops after its checkpoint at CLI_STOP
CLI_ARGS = ["--no-distributed", "--model", "alexnet", "--dtype", "bfloat16", "--epochs", "2",
            "--synthetic-data", "--synthetic-train-size", "640", "--synthetic-test-size", "128",
            "--batch-size", "32", "--log-interval", "10", "--optimizer", "adamw",
            "--lr-schedule", "cosine", "--grad-clip", "1.0", "--grad-accum", "2",
            "--steps-per-dispatch", "10", "--ckpt-every", "15"]
CLI_STOP, CLI_STEPS = 15, 40


def _relu_pool2_bf16_checks(torch, g):
    """(a) K2a/K2b in bfloat16 bit-identical to the plain versions at
    POOL_CASES_BF16 (bias or none, ties forced or not), each on the route
    the rule names, read from the per-route bfloat16 counts; timed per
    shape cold and warm at both batches beside the launch floor, the plain
    versions, ``max_pool2d(relu)`` in bfloat16 and the halved byte bound."""
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc

    dev, bf = torch.device("cuda"), torch.bfloat16
    err = {"fwd": 0.0, "bwd": 0.0}
    held = []
    for shape, misaligned, want in POOL_CASES_BF16:
        nb, h, w, c = shape
        xr = torch.randn(shape, generator=g, device=dev)
        gr = torch.randn((nb, h // 2, w // 2, c), generator=g, device=dev).to(bf)
        before = dict(fc.launches)
        for xin in (xr.to(bf), (torch.round(xr * 2) / 2).to(bf)):
            if misaligned:
                xin = torch.empty(xin.numel() + 1, device=dev, dtype=bf)[1:].view(
                    shape).copy_(xin)
            for bias in (None, torch.randn(c, generator=g, device=dev).to(bf)):
                mk = fc.relu_pool2_fwd_cuda(xin, bias)
                mp = fc.relu_pool2_fwd_plain(xin, bias)
                dk = fc.relu_pool2_bwd_cuda(xin, bias, mk, gr)
                dp = fc.relu_pool2_bwd_plain(xin, bias, mp, gr)
                torch.cuda.synchronize()
                what = f"bf16 {shape} misaligned={misaligned} bias={bias is not None}"
                require(mk.dtype == bf and torch.equal(mk, mp),
                        f"relu_pool2 fwd kernel != plain at {what}")
                require(dk.dtype == bf and torch.equal(dk, dp),
                        f"relu_pool2 bwd kernel != plain at {what}")
                err["fwd"] = max(err["fwd"], float((mk.float() - mp.float()).abs().max()))
                err["bwd"] = max(err["bwd"], float((dk.float() - dp.float()).abs().max()))
        ran = {k: fc.launches[k] - before[k] for k in fc.launches if k.startswith("relu_pool2")}
        require(all(ran[f"relu_pool2_{d}{key}"] == 4 for d in ("fwd", "bwd")
                    for key in ("", f".bf16.{want}")),
                f"relu_pool2 bf16 at {shape} (misaligned={misaligned}) ran {ran}, not the "
                f"{want} route")
        held.append({"shape": list(shape), "misaligned": misaligned, "route": want})

    one, two = torch.zeros(1, device=dev), torch.ones(1, device=dev)
    floor = device_ms(lambda: one.add_(two))
    rows = {b: [_time_pool_shape(torch, fc, (b, *t), g, bf) for t in POOL_TAILS]
            for b in POOL_BATCHES}

    def total(batch, key):
        return sum(r[key] for r in rows[batch])

    measured = {}
    for k, name in (("fwd", "relu_pool2_fwd.bf16"), ("bwd", "relu_pool2_bwd.bf16")):
        measured[name] = {
            "max_abs_err": err[k], "ms": total(1024, f"{k}_ms"),
            "plain_ms": total(1024, f"{k}_plain_ms"),
            "library_ms": total(1024, "fwd_library_ms") if k == "fwd" else None,
            "bound_ms": total(1024, f"{k}_bound_ms"), "bound_by": "bytes"}
    line = {"held": held, "launch_floor_ms": floor,
            "b1024_cold_sum_ms": {k: total(1024, f"{k}_ms") for k in ("fwd", "bwd")},
            "b1024_warm_sum_ms": {k: total(1024, f"{k}_warm_ms") for k in ("fwd", "bwd")},
            "b1024_bound_sum_ms": {k: total(1024, f"{k}_bound_ms") for k in ("fwd", "bwd")},
            "b1024_plain_sum_ms": {k: total(1024, f"{k}_plain_ms") for k in ("fwd", "bwd")},
            "b1024_library_fwd_sum_ms": total(1024, "fwd_library_ms"),
            "b64_warm_sum_ms": {k: total(64, f"{k}_warm_ms") for k in ("fwd", "bwd")},
            "b64_cold_sum_ms": {k: total(64, f"{k}_ms") for k in ("fwd", "bwd")},
            "shapes": rows[64] + rows[1024]}
    return measured, line


def _wall_ms(torch, fn) -> float:
    """Host wall ms of ``fn()``, ended by a synchronisation."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _graphed_vs_eager(torch) -> dict:
    """(b) ``make_scan_train_step`` (a graph of one step replayed) against
    as many eager steps from the same weights on the same batches: AlexNet
    fused, batch 64, K = SCAN_K, SGD lr 0.008, deterministic cuDNN; equal
    losses and parameters. Then each way's wall time for another K steps
    (host synchronisation included: one per dispatch graphed, one a step
    eager, as the per-step trainer reads each loss), one graphed dispatch
    profiled (K2a/K2b 3 a step, no lost launch, the idle share) and ten
    eager steps profiled."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    images, labels = bench_all.make_batch(64, k=SCAN_K)
    x, y = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    runs = {}
    for graphed in (True, False):
        model = get_model("alexnet", fused_epilogue=True, seed=0, device="cuda")
        tx = ttr.SGD(bench_all.ALEXNET_LR)
        state = ttr.create_train_state(model, tx)
        if graphed:
            scan = ttr.make_scan_train_step(model, tx)
            losses = scan(state, x, y)[1].cpu()
        else:
            step = ttr.make_train_step(model, tx)
            losses = torch.stack([step(state, x[i], y[i])[1] for i in range(SCAN_K)]).cpu()
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        runs[graphed] = (losses, flat, state)
    require(torch.equal(runs[True][0], runs[False][0]),
            "graphed K-step losses differ from the eager steps'")
    require(torch.equal(runs[True][1], runs[False][1]),
            "graphed K-step parameters differ from the eager steps'")
    require(scan.graphed.captures == 1, f"{scan.graphed.captures} captures, not 1")
    gstate, estate = runs[True][2], runs[False][2]
    graphed_ms = _wall_ms(torch, lambda: scan(gstate, x, y)[1].cpu()) / SCAN_K
    eager_ms = _wall_ms(torch, lambda: [float(step(estate, x[i], y[i])[1])
                                        for i in range(SCAN_K)]) / SCAN_K
    for k in fc.launches:
        fc.launches[k] = 0
    prof = kernel_breakdown(lambda: scan(gstate, x, y)[1], TRAINER_GROUPS, top=12)
    n = prof.get("group_launches", {})
    require("busy_ms" in prof and prof["lost_launches"] == 0,
            f"graphed dispatch: the profile lost kernels: {prof}")
    require(n["K2a relu_pool2_fwd"] == n["K2b relu_pool2_bwd"] == 3 * SCAN_K,
            f"graphed dispatch: K2 launches {n}, not {3 * SCAN_K} each")
    replay_counts = {k: v for k, v in fc.launches.items() if v}
    eager_prof = kernel_breakdown(lambda: [step(estate, x[i], y[i]) for i in range(10)],
                                  TRAINER_GROUPS, top=8)
    return {"steps_per_dispatch": SCAN_K, "batch": 64, "bit_equal": True,
            "graphed_ms_per_step": graphed_ms, "eager_ms_per_step": eager_ms,
            "graphed_images_per_s": 64e3 / graphed_ms, "eager_images_per_s": 64e3 / eager_ms,
            "graphed_profile": prof, "graphed_wrapper_counts_in_profile": replay_counts,
            "eager_profile_10_steps": eager_prof}


def _graphed_accumulation(torch) -> dict:
    """(c) ``grad_accum_b1024`` (batch 1024, microbatch 256, each update the
    sum of batch-64 mean-gradient updates) through
    ``make_scan_accum_train_step``: two dispatches of U = 2 (the graph's
    two eager warm-up updates, then a capture and a replay) against the same
    four updates of ``make_accum_train_step``: equal."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr

    images, labels = bench_all.make_batch(1024, k=4)
    x, y = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    kw = dict(effective_update_batch=bench_all.EFFECTIVE_UPDATE)
    runs = {}
    for graphed in (True, False):
        model = get_model("alexnet", fused_epilogue=True, seed=0, device="cuda")
        tx = ttr.SGD(bench_all.ALEXNET_LR)
        state = ttr.create_train_state(model, tx)
        if graphed:
            scan = ttr.make_scan_accum_train_step(model, tx, bench_all.ACCUM_MICROBATCH, **kw)
            losses = torch.cat([scan(state, x[i:i + 2], y[i:i + 2])[1] for i in (0, 2)])
        else:
            step = ttr.make_accum_train_step(model, tx, bench_all.ACCUM_MICROBATCH, **kw)
            losses = torch.stack([step(state, x[i], y[i])[1] for i in range(4)])
        runs[graphed] = (losses.cpu(), torch.cat([p.detach().reshape(-1)
                                                  for p in model.parameters()]))
    require(scan.graphed.captures == 1, "the accumulation step was never captured")
    require(torch.equal(runs[True][0], runs[False][0])
            and torch.equal(runs[True][1], runs[False][1]),
            "graphed accumulation updates differ from the eager ones")
    return {"updates": 4, "dispatches": "2 x U=2", "bit_equal": True,
            "losses": runs[True][0].tolist()}


def _bf16_step_profile(torch) -> dict:
    """AlexNet fused in bfloat16 (the trainer's ``--dtype bfloat16``) at
    config 1's batch 1024, SGD lr 0.008, 5 steps a dispatch as a CUDA graph
    under cuDNN's default algorithms: ms a step (``utils/devtime``, beside
    the float32 leg of phase 13) and one dispatch profiled, K2's bfloat16
    kernels 3 times a step each."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown
    from distributed_ml_pytorch_tpu_torch.utils.devtime import device_time

    k = 5
    model = get_model("alexnet", fused_epilogue=True, seed=0, device="cuda",
                      dtype=torch.bfloat16)
    tx = ttr.SGD(bench_all.ALEXNET_LR)
    state = ttr.create_train_state(model, tx)
    scan = ttr.make_scan_train_step(model, tx)
    images, labels = bench_all.make_batch(1024, k=k)
    x, y = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    losses = scan(state, x, y)[1].cpu().tolist()  # warm-up steps and the capture
    step_ms = device_time(lambda: scan(state, x, y)[1], calls=3, warmup=1).per_call_ms / k
    prof = kernel_breakdown(lambda: scan(state, x, y)[1], TRAINER_GROUPS, top=8)
    n = prof.get("group_launches", {})
    require("busy_ms" in prof and prof["lost_launches"] == 0,
            f"bf16 batch-1024 dispatch: the profile lost kernels: {prof}")
    require(n["K2a relu_pool2_bf16_fwd"] == n["K2b relu_pool2_bf16_bwd"] == 3 * k
            and n["K2a relu_pool2_fwd"] == n["K2b relu_pool2_bwd"] == 0,
            f"bf16 batch-1024 dispatch: K2 launches {n}, not {3 * k} bf16 each")
    return {"batch": 1024, "steps_per_dispatch": k, "step_ms": step_ms,
            "images_per_s": 1024e3 / step_ms, "first_losses": losses, "profile": prof}


def _accum_profile(torch) -> dict:
    """The ``grad_accum_b1024`` update as the leg runs it (batch 1024,
    microbatch 256, update scaled to batch 64, float32, cuDNN's default
    algorithms), graphed: one dispatch of 2 updates profiled after the
    warm-up and the capture, K2a/K2b 3 a microbatch each."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    u, micro = 2, bench_all.ACCUM_MICROBATCH
    model = get_model("alexnet", fused_epilogue=True, seed=0, device="cuda")
    tx = ttr.SGD(bench_all.ALEXNET_LR)
    state = ttr.create_train_state(model, tx)
    scan = ttr.make_scan_accum_train_step(
        model, tx, micro, effective_update_batch=bench_all.EFFECTIVE_UPDATE)
    images, labels = bench_all.make_batch(1024, k=u)
    x, y = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    for _ in range(2):  # the two eager warm-up updates, then the capture and a replay
        scan(state, x, y)[1].cpu()
    prof = kernel_breakdown(lambda: scan(state, x, y)[1], TRAINER_GROUPS, top=8)
    n = prof.get("group_launches", {})
    want = 3 * (1024 // micro) * u
    require("busy_ms" in prof and prof["lost_launches"] == 0,
            f"graphed accumulation: the profile lost kernels: {prof}")
    require(n["K2a relu_pool2_fwd"] == n["K2b relu_pool2_bwd"] == want,
            f"graphed accumulation: K2 launches {n}, not {want} each")
    return {"batch": 1024, "microbatch": micro, "updates_per_dispatch": u,
            "captures": scan.graphed.captures, "profile": prof}


class _Stop(Exception):
    pass


def _tensors(tree) -> list:
    """Every tensor of a nested dict/list, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if hasattr(tree, "shape") else []


def _cli_resume(torch) -> dict:
    """(d) ``train_single`` through ``training/cli.main`` (CLI_ARGS: bf16,
    10 steps a dispatch, accumulation 2, adamw, cosine, clipping): run to
    the end under the profiler (the bfloat16 K2 kernels must be in it, on
    the vector route by the wrappers' counts), then run again, stopped
    right after the checkpoint at step CLI_STOP, and resumed with
    ``--resume``: the final checkpoints (parameters, optimizer state,
    generator) and the CSV losses from the resumed step on equal the
    uninterrupted run's."""
    import csv
    import shutil

    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.training import cli
    from distributed_ml_pytorch_tpu_torch.utils import checkpoint as ck
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    root = os.path.join(ROOT, "build", "smoke_trainer")

    def argv(tag):
        return [*CLI_ARGS, "--ckpt-dir", os.path.join(root, tag, "ck"),
                "--log-dir", os.path.join(root, tag)]

    def full_run():
        shutil.rmtree(os.path.join(root, "full"), ignore_errors=True)
        require(cli.main(argv("full")) == 0, "the CLI run failed")

    for k in fc.launches:
        fc.launches[k] = 0
    prof = kernel_breakdown(full_run, TRAINER_GROUPS, top=12)
    n = prof.get("group_launches", {})
    require("busy_ms" in prof and prof["lost_launches"] == 0,
            f"CLI run: the profile lost kernels: {prof}")
    require(n["K2a relu_pool2_bf16_fwd"] > 0 and n["K2b relu_pool2_bf16_bwd"] > 0
            and n["K2a relu_pool2_fwd"] == n["K2b relu_pool2_bwd"] == 0,
            f"CLI run: K2 launches in the profile {n}: the bf16 kernels must run, the "
            f"float32 ones not")
    counts = dict(fc.launches)
    require(all(counts[f"relu_pool2_{d}.bf16.vector"] > 0
                and counts[f"relu_pool2_{d}.bf16.scalar"] == 0 for d in ("fwd", "bwd")),
            f"CLI run: K2 wrapper counts {counts}: not the bf16 vector route")

    shutil.rmtree(os.path.join(root, "cut"), ignore_errors=True)
    real_save = ck.Checkpointer.save

    def save_then_stop(self, step, state, *, force=False):
        accepted = real_save(self, step, state, force=force)
        if accepted and not force and step == CLI_STOP:
            raise _Stop
        return accepted

    ck.Checkpointer.save = save_then_stop
    try:
        cli.main(argv("cut"))
        stopped = False
    except _Stop:
        stopped = True
    finally:
        ck.Checkpointer.save = real_save
    require(stopped, f"the interrupted run was not stopped at step {CLI_STOP}")
    require(cli.main([*argv("cut"), "--resume"]) == 0, "the resumed CLI run failed")

    def final(tag):
        return torch.load(os.path.join(root, tag, "ck", str(CLI_STEPS), "state.pt"),
                          weights_only=True)

    def losses(tag):
        with open(os.path.join(root, tag, "gpu.csv"), newline="") as fh:
            return [(r["iteration"], r["training_loss"], r["test_loss"])
                    for r in csv.DictReader(fh)]

    a, b = final("full"), final("cut")
    require(a["step"] == b["step"] == CLI_STEPS, f"final steps {a['step']}, {b['step']}")
    require(all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"]),
            "resumed run's final parameters differ from the uninterrupted run's")
    require(all(torch.equal(u, v) for u, v in zip(_tensors(a["opt_state"]),
                                                  _tensors(b["opt_state"]))),
            "resumed run's final optimizer state differs from the uninterrupted run's")
    require(torch.equal(a["generator"], b["generator"]), "generator states differ")
    rows_full, rows_cut = losses("full"), losses("cut")
    require(len(rows_full) == CLI_STEPS and rows_cut == rows_full[CLI_STOP:],
            "resumed run's CSV losses differ from the uninterrupted run's")
    return {"argv": CLI_ARGS, "steps": CLI_STEPS, "stopped_at": CLI_STOP, "bit_equal": True,
            "profile": prof, "wrapper_counts": {k: v for k, v in counts.items() if v},
            "final_loss": float(rows_full[-1][1])}


def phase_trainer_family(torch):
    """Phase 14: the trainer family — (a) K2 in bfloat16, a bfloat16
    batch-1024 step and the graphed accumulation update profiled, (b) the graphed
    K-step trainer, (c) the graphed accumulation step, (d) the CLI's
    bfloat16 run with resume. Returns the kernels line's bfloat16 rows and
    their launches (from (d)'s profile: the graph's replays do not pass
    through the wrappers)."""
    g = torch.Generator(device="cuda").manual_seed(14)
    measured, pool_line = _relu_pool2_bf16_checks(torch, g)
    emit({"phase": "trainer_family_relu_pool2_bf16", "ok": True, **pool_line})
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        torch.backends.cudnn.deterministic = torch.backends.cudnn.benchmark = False
        emit({"phase": "trainer_family_bf16_b1024", "ok": True, **_bf16_step_profile(torch)})
        emit({"phase": "trainer_family_accum_profile", "ok": True, **_accum_profile(torch)})
        torch.backends.cudnn.deterministic = True
        emit({"phase": "trainer_family_graphed_scan", "ok": True, **_graphed_vs_eager(torch)})
        emit({"phase": "trainer_family_graphed_accum", "ok": True,
              **_graphed_accumulation(torch)})
        run = _cli_resume(torch)
        emit({"phase": "trainer_family_cli_resume", "ok": True, **run})
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    n = run["profile"]["group_launches"]
    return measured, {"relu_pool2_fwd.bf16": n["K2a relu_pool2_bf16_fwd"],
                      "relu_pool2_bwd.bf16": n["K2b relu_pool2_bf16_bwd"]}


# ------------------------------------------------------------------ phase 15

#: (a)'s single worker: steps a pass (n_push = n_pull = 10: runs of 1 and 9)
CHUNK_STEPS = 60
#: (c)'s server directory (emptied first: the log is opened for appending)
SMOKE_PS_DIR = os.path.join(ROOT, "build", "smoke_ps")
#: (b)'s profiled run: the 9-step run between two gaps at n_push = n_pull = 10
CHUNK_PROFILE_LEN = 9


def _recording_worker(torch, seed=0):
    """A DownPour worker (AlexNet fused, batch 64's lr 0.008, n_push = n_pull
    = 10) on a transport nobody answers, its pushes recorded."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport, MessageCode

    model = get_model("alexnet", fused_epilogue=True, seed=seed, device="cuda")
    opt = tps.Asynchronous(model, lr=0.008, n_push=10, n_pull=10,
                           transport=InProcessTransport.create_world(2)[1])
    pushes = []

    def record(code, payload):
        if code == MessageCode.GradientUpdate:
            pushes.append(payload.copy())

    opt._send = record
    gen = torch.Generator(device="cuda").manual_seed(1)
    return model, opt, pushes, gen


def _worker_pass(torch, opt, model, gen, x, y, start, chunked):
    """Steps ``[start, start + len(x))`` of one worker, chunked (``boundary``
    and one graph dispatch a run, the losses read once at the end) or per
    step (each loss read, as the per-step worker logs it); returns the host
    wall ms, ended by a synchronisation."""
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads, to_device

    n = len(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if chunked:
        chunk = tps._chunk_step_cache(opt, 64)
        losses = []
        for gap, length in tps.downpour_chunk_schedule(10, 10, start, start + n):
            opt.boundary(gap)
            a = gap - start
            losses.append(chunk(opt.opt_state, x[a:a + length], y[a:a + length], gen))
            opt.idx = gap + length
        torch.cat(losses).cpu()
    else:
        for i in range(n):
            float(loss_and_grads(model, *to_device(x[i], y[i], "cuda"), generator=gen))
            opt.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _chunked_vs_per_step(torch):
    """(a) and (b): one worker chunked (graphs) and one per step (eager) from
    the same weights on the same batches, CHUNK_STEPS steps each: pushes and
    final parameters bit for bit, one capture; a second pass of each timed;
    then one 9-step run of the chunked worker profiled (K1 9 times, K2a and
    K2b 27 each, no launch lost) and the boundary's parts timed: an install
    of the central vector and a snapshot plus push."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.data import load_cifar10
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import downpour_chunk_schedule
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    x, y, *_ = load_cifar10(synthetic=True, n_train=3 * CHUNK_STEPS * 64, n_test=16)
    x = x.reshape(3 * CHUNK_STEPS, 64, 32, 32, 3)
    y = y.reshape(3 * CHUNK_STEPS, 64)
    workers = {}
    for chunked in (True, False):
        workers[chunked] = _recording_worker(torch)
    wall_ms = {}
    for p, start in enumerate((0, CHUNK_STEPS)):
        for chunked in (True, False):
            model, opt, pushes, gen = workers[chunked]
            ms = _worker_pass(torch, opt, model, gen, x[start:start + CHUNK_STEPS],
                              y[start:start + CHUNK_STEPS], start, chunked)
            opt._flusher.drain()
            if p == 1:
                wall_ms[chunked] = ms / CHUNK_STEPS
        if p == 0:
            (mc, oc, pc, _), (mp, _op, pp, _) = workers[True], workers[False]
            require(len(pc) == len(pp) == CHUNK_STEPS // 10
                    and all(np.array_equal(a, b) for a, b in zip(pc, pp)),
                    "the chunked worker's pushes differ from the per-step worker's")
            require(all(torch.equal(a, b) for a, b in zip(mc.parameters(), mp.parameters())),
                    "the chunked worker's parameters differ from the per-step worker's")
            captures = oc._chunk_step.graphed.captures
            require(captures == 1, f"{captures} captures, not 1 for every run length")
    (model, opt, _pushes, gen) = workers[True]
    start = 2 * CHUNK_STEPS
    require(downpour_chunk_schedule(10, 10, start, start + 10)[1] == (start + 1, 9),
            "the schedule's second run is not 9 steps")
    _worker_pass(torch, opt, model, gen, x[start:start + 1], y[start:start + 1], start, True)
    chunk = opt._chunk_step
    xs, ys = x[start + 1:start + 10], y[start + 1:start + 10]
    opt.boundary(start + 1)
    prof = kernel_breakdown(lambda: chunk(opt.opt_state, xs, ys, gen), ALEXNET_GROUPS, top=12)
    require("busy_ms" in prof and prof["lost_launches"] == 0,
            f"chunked dispatch: the profile lost kernels: {prof}")
    n = prof["group_launches"]
    want = {"K1 flat_axpy": CHUNK_PROFILE_LEN, "K2a relu_pool2_fwd": 3 * CHUNK_PROFILE_LEN,
            "K2b relu_pool2_bwd": 3 * CHUNK_PROFILE_LEN}
    require(all(n[k] == v for k, v in want.items()),
            f"chunked dispatch: profiled launches {n} (want {want})")
    # the boundary's parts, each ended by a synchronisation: the install of
    # a 9.9 MB central vector; a snapshot handed to the flusher (what the
    # training thread pays), and the same until the flusher has copied it
    # to the host and sent it (what overlaps the next steps)
    central = ravel_model_params(model).cpu().numpy()
    install_ms = statistics_ms(torch, lambda: opt.install(central))
    enqueue_ms = []
    for _ in range(6):
        opt._flusher.drain()
        enqueue_ms.append(_wall_ms(torch, opt._push))
    opt._flusher.drain()
    enqueue_ms = sum(enqueue_ms[1:]) / 5
    push_ms = statistics_ms(torch, lambda: (opt._push(), opt._flusher.drain()))
    opt.finish()
    workers[False][1].finish()
    return {"steps": CHUNK_STEPS, "batch": 64, "bit_equal": True, "captures": 1,
            "chunked_ms_per_step": wall_ms[True], "per_step_ms_per_step": wall_ms[False],
            "chunked_images_per_s": 64e3 / wall_ms[True],
            "per_step_images_per_s": 64e3 / wall_ms[False],
            "profile_9_steps": prof, "busy_ms_per_step": prof["busy_ms"] / CHUNK_PROFILE_LEN,
            "idle_share": prof["idle_share"], "install_ms": install_ms,
            "snapshot_enqueue_ms": enqueue_ms, "snapshot_to_sent_ms": push_ms,
            "boundary_training_thread_ms_per_10_steps": install_ms + enqueue_ms}


def statistics_ms(torch, fn, reps: int = 5) -> float:
    """Mean host wall ms of ``fn()`` over ``reps`` calls, each ended by a
    synchronisation, after one warm-up call."""
    fn()
    return sum(_wall_ms(torch, fn) for _ in range(reps)) / reps


def _chunked_world(torch, per_step_workers) -> dict:
    """(c) and (d): the two-worker world chunked, with the server's log, its
    checkpoint and its admission gate; then a fresh server restores the
    directory."""
    import shutil

    import numpy as np

    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer
    from distributed_ml_pytorch_tpu_torch.training.trainer import GRAPH_WARMUP_STEPS
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

    shutil.rmtree(SMOKE_PS_DIR, ignore_errors=True)
    srv, per_worker, launches, wall, _records = _downpour_world(
        torch, ["--chunked-dispatch", "on", "--ckpt-dir", SMOKE_PS_DIR, "--wal",
                "--admission"])
    counts = {c.name: k for c, k in srv.message_counts.items() if k}
    require(all(w["steps"] == WORKER_STEPS for w in per_worker.values()),
            f"chunked workers took too few steps: {per_worker}")
    for r, w in per_worker.items():
        require(w["late_loss"] < w["early_loss"], f"chunked worker {r} loss did not fall: {w}")
    require(srv.message_counts[MessageCode.GradientUpdate] >= 2 * (WORKER_STEPS // 10)
            and srv.message_counts[MessageCode.ParameterRequest] >= 2 * (WORKER_STEPS // 10),
            f"the server counted too few pushes or pulls: {counts}")
    require(srv.quarantined == 0, f"the admission gate quarantined {srv.quarantined} pushes")
    # each worker's wrappers see its eager warm-up steps and the capture
    # (the replays pass none), and K2a its epoch-end eval's one test batch
    per_graph = GRAPH_WARMUP_STEPS + 1
    require(launches["flat_axpy"] == 2 * per_graph
            and launches["relu_pool2_bwd.vector"] == 2 * 3 * per_graph
            and launches["relu_pool2_fwd.vector"] == 2 * 3 * (per_graph + 1),
            f"chunked world wrapper counts {launches} (want {per_graph} steps and one "
            f"eval batch a worker)")
    fresh = ParameterServer(get_model("alexnet", seed=0, device="cpu"), ckpt_dir=SMOKE_PS_DIR,
                            wal=True)
    require(fresh.maybe_restore(), "nothing to restore")
    require(np.array_equal(fresh.central, srv.central) and fresh._apply_seq == srv._apply_seq
            and fresh.staleness.version == srv.staleness.version,
            "the restored server differs from the chunked world's final state")
    fresh.wal.close()
    return {"workers": 2, "batch": 64, "wall_s": wall, "dispatch": "chunked",
            "per_worker": per_worker, "per_step_per_worker": per_step_workers,
            "server_messages": counts, "apply_seq": srv._apply_seq,
            "quarantined": srv.quarantined, "wal_records_replayed": fresh.replayed_updates,
            "restored_bit_equal": True, "wrapper_counts": {
                k: v for k, v in launches.items() if v}}


def phase_chunked_worker(torch, per_step_workers):
    """Phase 15: the chunked DownPour worker, under deterministic cuDNN in
    full float32; returns (c)'s per-worker rates."""
    from distributed_ml_pytorch_tpu_torch.device import full_float32

    full_float32()
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        emit({"phase": "chunked_worker_vs_per_step", "ok": True,
              **_chunked_vs_per_step(torch)})
        world = _chunked_world(torch, per_step_workers)
        emit({"phase": "chunked_worker_world", "ok": True, **world})
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    return world["per_worker"]


# ------------------------------------------------------------------ phase 16

#: (a)'s server directory (emptied first: the log is opened for appending);
#: the other worlds' beside it
SMOKE_PS_MP_DIR = os.path.join(ROOT, "build", "smoke_ps_mp")
#: phase 16's worlds, in the order they run: (letter, phase name, wire
#: flags, reliable, the transport under the reliable layer). (a) and (b)
#: differ in two things at once; (e) and (f) take one of them each, so the
#: four together part the native transport's share from the reliable
#: layer's
PS_WORLDS = [
    ("a", "ps_processes_reliable_native", ["--transport", "native", "--reliable"], True,
     "NativeTCPTransport"),
    ("b", "ps_processes_plain_python", ["--transport", "python"], False, "TCPTransport"),
    ("e", "ps_processes_plain_native", ["--transport", "native"], False,
     "NativeTCPTransport"),
    ("f", "ps_processes_reliable_python", ["--transport", "python", "--reliable"], True,
     "TCPTransport"),
]
#: seconds a phase-16 process may take
PS_PROCESS_TIMEOUT_S = 300

#: one rank of the PS world: ``python -c _PS_RANK_SRC <json argv> <central
#: path>``. Calls the CLI's entry ``run_ps_process`` with every kernel count
#: zeroed just before, wrapping (never replacing) the functions it calls to
#: see the transport, the server, the worker's log and its chunk step, and
#: prints one JSON line last.
_PS_RANK_SRC = r"""
import json, sys
import numpy as np
import torch
from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.training.cli import build_parser
from distributed_ml_pytorch_tpu_torch.utils import messaging as msg
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

args = build_parser().parse_args(json.loads(sys.argv[1]))
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
seen = {"pushes": 0}

def wrap(mod, name, after):
    real = getattr(mod, name)
    def wrapped(*a, **k):
        out = real(*a, **k)
        after(out)
        return out
    setattr(mod, name, wrapped)

wrap(msg, "make_transport", lambda t: seen.setdefault("transport", t))
wrap(tps, "run_server", lambda srv: seen.setdefault("server", srv))
wrap(tps, "train_worker", lambda out: seen.setdefault("logger", out[1]))
wrap(tps, "_chunk_step_cache", lambda step: seen.setdefault("chunk", step))
real_send = tps.Asynchronous._send

def counting_send(self, code, payload):
    if code == MessageCode.GradientUpdate:
        seen["pushes"] += 1
    return real_send(self, code, payload)

tps.Asynchronous._send = counting_send
fu.launches = 0
for k in fc.launches:
    fc.launches[k] = 0
rc = tps.run_ps_process(args)
t = seen["transport"]
inner = getattr(t, "inner", t)
line = {"rank": args.rank, "rc": rc, "transport": type(t).__name__,
        "inner": type(inner).__name__, "stats": getattr(t, "stats", None),
        # the reliable layer's timeout state per peer at the end of the run
        "peers": {str(d): {"srtt": st.srtt, "rto": st.rto}
                  for d, st in (t._peers.items() if t is not inner else ())}}
if "server" in seen:
    srv = seen["server"]
    np.save(sys.argv[2], srv.central)
    line.update(message_counts={c.name: n for c, n in srv.message_counts.items() if n},
                apply_seq=srv._apply_seq, version=srv.staleness.version,
                quarantined=srv.quarantined,
                applied_by_sender={str(k): v for k, v in srv.applied_by_sender.items()},
                recent_envelopes=len(srv._recent_envelopes))
else:
    recs = seen["logger"].records
    line.update(launches={"flat_axpy": fu.launches, **fc.launches},
                captures=seen["chunk"].graphed.captures, pushes_sent=seen["pushes"],
                acked_pushes=(t.acked_count(0, MessageCode.GradientUpdate)
                              if hasattr(t, "acked_count") else None),
                t=[r["timestamp"].timestamp() for r in recs],
                loss=[r["training_loss"] for r in recs])
print("PS_RANK " + json.dumps(line), flush=True)
"""


def _ps_processes(wire, ckpt_dir, backend="cuda", model="alexnet", steps=WORKER_STEPS,
                  batch=64):
    """One server and two worker processes over TCP on a free port, every
    process from :data:`_PS_RANK_SRC` with phase 15 (c)'s recipe plus
    ``--wal --admission --ckpt-dir ckpt_dir`` and ``wire``. Returns ``({rank:
    line}, wall_s)``; a process that exits non-zero, or prints no line,
    fails the phase (the others are killed)."""
    import shutil
    import socket

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    with socket.socket() as s:
        s.bind(("", 0))
        port = str(s.getsockname()[1])
    common = ["--mode", "ps", "--world-size", "3", "--port", port, "--backend", backend,
              "--model", model, "--epochs", "1", "--synthetic-data",
              "--synthetic-train-size", str(steps * batch), "--synthetic-test-size", "512",
              "--batch-size", str(batch), "--lr", "0.008", "--num-push", "10",
              "--num-pull", "10", "--log-interval", str(10 * steps), "--worker-timeout", "0",
              "--log-dir", ckpt_dir + "_runs", "--chunked-dispatch", "on", "--wal",
              "--admission", "--ckpt-dir", ckpt_dir, *wire]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    procs = {}
    for rank in (0, 1, 2):
        argv = common + ["--rank", str(rank)] + (["--server"] if rank == 0 else [])
        procs[rank] = subprocess.Popen(
            [sys.executable, "-c", _PS_RANK_SRC, json.dumps(argv), ckpt_dir + ".central.npy"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines, failed = {}, []
    try:
        for rank, p in procs.items():
            try:
                out, err = p.communicate(timeout=PS_PROCESS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} did not finish in {PS_PROCESS_TIMEOUT_S} s")
                break
            found = [ln for ln in out.splitlines() if ln.startswith("PS_RANK ")]
            if p.returncode != 0 or not found:
                failed.append(f"rank {rank} exited {p.returncode}: {err[-3000:]}")
                break
            lines[rank] = json.loads(found[-1][len("PS_RANK "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    require(not failed, "; ".join(failed))
    return lines, time.monotonic() - t0


def _ps_world_checks(lines, reliable, steps=WORKER_STEPS, backend="cuda"):
    """(a)'s and (b)'s checks; returns the per-worker summary."""
    from distributed_ml_pytorch_tpu_torch.training.trainer import GRAPH_WARMUP_STEPS

    srv = lines[0]
    workers = {r: lines[r] for r in (1, 2)}
    applied = srv["message_counts"].get("GradientUpdate", 0)
    sent = sum(w["pushes_sent"] for w in workers.values())
    require(srv["quarantined"] == 0, f"{srv['quarantined']} pushes quarantined")
    require(applied == srv["apply_seq"] == sent,
            f"applied {applied}, apply_seq {srv['apply_seq']}, sent {sent}")
    require(all(ln["rc"] == 0 for ln in lines.values()), "a rank returned non-zero")
    s = _steady_record(steps)
    per_worker = {}
    per_graph = GRAPH_WARMUP_STEPS + 1
    for r, w in workers.items():
        loss, t = w["loss"], w["t"]
        require(len(loss) == steps, f"worker {r} logged {len(loss)} of {steps} steps")
        early, late = sum(loss[:10]) / 10, sum(loss[-10:]) / 10
        require(late < early, f"worker {r} loss did not fall: {early} -> {late}")
        if backend == "cuda":
            require(w["captures"] == 1, f"worker {r} captured {w['captures']} graphs, not 1")
            n = w["launches"]
            require(n["flat_axpy"] == per_graph
                    and n["relu_pool2_bwd.vector"] == 3 * per_graph
                    and n["relu_pool2_fwd.vector"] == 3 * (per_graph + 1),
                    f"worker {r} wrapper counts {n} (want {per_graph} steps and one eval "
                    f"batch)")
        steady = (len(t) - 1 - s) / (t[-1] - t[s])
        per_worker[r] = {"steps": len(loss), "early_loss": early, "late_loss": late,
                         "steady_from_step": s + 1, "steady_steps_per_s": steady,
                         "steady_images_per_s": steady * 64, "pushes_sent": w["pushes_sent"],
                         "captures": w["captures"],
                         "wrapper_counts": {k: v for k, v in w["launches"].items() if v}}
        if reliable:
            st = w["stats"]
            per_worker[r].update(acked_pushes=w["acked_pushes"], **{
                k: st[k] for k in ("sent", "retries", "dup_dropped", "crc_dropped",
                                   "gave_up", "window_blocked", "window_blocked_s")})
    if reliable:
        acked = sum(w["acked_pushes"] for w in workers.values())
        require(acked == applied, f"acked pushes {acked} != applied {applied}")
        for r, ln in lines.items():
            require(ln["stats"]["gave_up"] == 0 and ln["stats"]["crc_dropped"] == 0,
                    f"rank {r} reliable stats {ln['stats']}")
            require(ln["transport"] == "ReliableTransport", f"rank {r}: {ln['transport']}")
    return per_worker


def _ps_world_line(lines, reliable, wall, in_process, steps=WORKER_STEPS, backend="cuda"):
    per_worker = _ps_world_checks(lines, reliable, steps, backend)
    srv = lines[0]
    return {"workers": 2, "batch": 64, "wall_s": wall, "processes": 3,
            "transport": {r: [ln["transport"], ln["inner"]] for r, ln in lines.items()},
            "per_worker": per_worker, "in_process_per_worker_15c": in_process,
            "server_messages": srv["message_counts"], "apply_seq": srv["apply_seq"],
            "quarantined": srv["quarantined"], "server_stats": srv["stats"],
            "peer_timeouts": {r: ln["peers"] for r, ln in lines.items() if ln["peers"]}}


def phase_ps_processes(torch, in_process, backend="cuda", model="alexnet",
                       steps=WORKER_STEPS, bench=True):
    """Phase 16: the DownPour world as processes, (a)-(f)."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        InProcessTransport,
        ReliableTransport,
    )

    srv = None
    for letter, name, wire, reliable, inner in PS_WORLDS:
        ckpt_dir = SMOKE_PS_MP_DIR if letter == "a" else f"{SMOKE_PS_MP_DIR}_{letter}"
        lines, wall = _ps_processes(wire, ckpt_dir, backend, model, steps)
        for r, ln in lines.items():
            require(ln["inner"] == inner, f"({letter}) rank {r} runs {ln['inner']}")
            require(reliable or ln["transport"] == inner,
                    f"({letter}) rank {r} runs {ln['transport']}")
        emit({"phase": name, "ok": True, "world": letter,
              **_ps_world_line(lines, reliable, wall, in_process, steps, backend)})
        if letter == "a":
            srv = lines[0]
    # (c) restore (a)'s directory into a fresh server on a reliable transport
    t = ReliableTransport(InProcessTransport.create_world(3)[0], ack_on_delivery=False)
    fresh = ParameterServer(get_model(model, seed=0, device="cpu"), transport=t,
                            ckpt_dir=SMOKE_PS_MP_DIR, wal=True)
    try:
        require(fresh.maybe_restore(), "nothing to restore")
        central = np.load(SMOKE_PS_MP_DIR + ".central.npy")
        require(np.array_equal(fresh.central, central)
                and fresh._apply_seq == srv["apply_seq"]
                and fresh.staleness.version == srv["version"],
                "the restored server differs from (a)'s final state")
        seeded = {r: len(t._seen.get(r, ())) for r in (1, 2)}
        require(len(fresh._recent_envelopes) == srv["recent_envelopes"] > 0
                and all(seeded.values()),
                f"dedup not seeded from the envelopes: {seeded}")
    finally:
        fresh.wal.close()
        t.detach()
    emit({"phase": "ps_processes_restore", "ok": True, "restored_bit_equal": True,
          "apply_seq": fresh._apply_seq, "envelopes": len(fresh._recent_envelopes),
          "dedup_seeded_per_sender": seeded})
    if bench:
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.bench_all",
                               "--legs", "ps"], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        require(proc.returncode == 0, f"bench_all --legs ps exited {proc.returncode}: "
                                      f"{proc.stderr[-3000:]}")
        records = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        require(len(records) == 4, f"bench_all --legs ps printed {len(records)} records")
        emit({"phase": "ps_bench_legs", "ok": True, "records": records})


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
    ("relu_pool2_fwd.bf16", "distributed_ml_pytorch_tpu_torch/csrc/fused_conv.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:321"),
    ("relu_pool2_bwd.bf16", "distributed_ml_pytorch_tpu_torch/csrc/fused_conv.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:311"),
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
    # a hang dumps every thread's stack and fails the run inside its limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        phase_device_and_build(torch)
        measured = phase_kernels(torch)
        phase_trainer(torch)
        phase_trainer(torch, steps=2, batch=1024)
        launches, per_step_workers = phase_downpour(torch)
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
        phase_alexnet(torch)
        bf16_measured, bf16_launches = phase_trainer_family(torch)
        measured.update(bf16_measured)
        launches.update(bf16_launches)
        in_process = phase_chunked_worker(torch, per_step_workers)
        phase_ps_processes(torch, in_process)
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
    faulthandler.cancel_dump_traceback_later()
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
