"""The legs of the JAX ``bench_all.py`` that the port runs on the card.

    python -m distributed_ml_pytorch_tpu_torch.bench_all                    # every leg, on the card
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs alexnet
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs conv_epilogue
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs ps
    python -m distributed_ml_pytorch_tpu_torch.bench_all --device cpu --tiny

One JSON line per measurement on stdout (the JAX ``emit`` record: config,
metric, value, unit, hardware, note, and the FLOPs story where there is one),
narration on stderr. Ported legs, under the JAX metric names:

- ``lm`` — config 6, LM training throughput (JAX bench_all.py:253-279): the
  default ``TransformerLM`` (bf16, RoPE, no remat) at batch 1 x seq 8192,
  and GPT-2-small (vocab 50304, 768d, 12 heads, 12 layers, d_ff 3072, bf16,
  RoPE) at 8 x 2048 and 1 x 8192, each through :func:`bench_lm`. A model with
  a detachable head trains through ``ops/fused_head.make_fused_head_sgd_step``
  (the restructured lm_head step), any other through
  ``parallel/fsdp.make_fsdp_lm_train_step``; both plain SGD at lr 1e-3 on the
  same tokens from ``default_rng(0)``.
- ``alexnet`` — config 1's three headline AlexNet legs (JAX ``bench.py::
  run_headline_legs``, bench.py:303, as ``tpu_phase`` emits them,
  bench_all.py:126-148), each as the JAX harness runs it: the reference
  recipe (batch 64, SGD lr 0.008, unfused; ``parity_b64``) at 100 steps a
  dispatch, AlexNet with the fused relu->pool epilogue at batch 1024
  (``large_batch_b1024``) at 20 a dispatch, that leg unfused too (what the
  epilogue kernels save in the step), and ``grad_accum_b1024``: batch 1024
  as microbatch-256 accumulation whose update is the sum of the sixteen
  batch-64 mean-gradient updates (``effective_update_batch=64``), fused, 20
  updates a dispatch, its FLOPs the batch-1024 leg's. A dispatch is
  ``training/trainer.make_scan_train_step`` (or ``make_scan_accum_train_step``)
  over K distinct batches of ``bench.py::make_batch``, on the card once: a
  CUDA graph of one step replayed K times. Full float32; FLOPs are
  ``utils/flops.cnn_train_flops`` over the model's conv/linear MACs, against
  the card's float32 (non-tensor) peak.
- ``ps`` — config 3's DownPour world as processes (JAX ``ps_phase``,
  bench_all.py:817-856, and ``ps_tpu_phase``, :1582-1646): one server and
  four worker processes over TCP through ``launch.launch_world``, 512
  synthetic images a worker, one epoch, emitting
  ``async_ps_4worker_aggregate_throughput`` from the wall time with startup
  included; then one server process and one chunked worker process on the
  card, 16384 synthetic images, two epochs at batch 64, against the same
  recipe in ``--no-distributed --steps-per-dispatch 10``, each rate the
  steady rate of its CSV's timestamps (:func:`_steady_rate_from_csv`), as
  ``async_ps_gpu_worker_throughput``, ``single_mode_scanned_throughput``
  and ``async_ps_push_pull_overhead``.
- ``conv_epilogue`` — config 1's conv-epilogue ladder (JAX
  ``compute_microbench_phase``, bench_all.py:2000-2073): ``relu_pool2``
  fused against ``max_pool_2x2(relu(x))`` on AlexNet's three relu->pool
  tails at batch 256, and ``bias_relu`` fused against ``relu(x + b)`` on a
  (4096, 384) tail, forward and forward+backward.

``--tiny`` shrinks every leg to test widths (a CPU run in seconds); its
records keep the metric names and say so in their notes. Timing is
``utils/devtime.device_time``: CUDA events on the card, wall clock on the
CPU (the record's note names the source). The LM legs' FLOP numerator is
``utils/flops.lm_train_flops_6nd`` over the non-embedding parameters (XLA's
``compiled_flops`` has no PyTorch counterpart); the cross-check holds it
against the same count over the ``nn.Linear`` weights. Not ported yet:
``bench_steps_to_accuracy``, ``bench_lm_32k``, the MoE leg and every other
phase of the JAX harness (``ROADMAP.md`` Queue A).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.device import full_float32, resolve_device
from distributed_ml_pytorch_tpu_torch.models import TransformerLM, get_model
from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
from distributed_ml_pytorch_tpu_torch.ops.fused_head import make_fused_head_sgd_step
from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
    create_lm_train_state,
    next_token_targets,
)
from distributed_ml_pytorch_tpu_torch.parallel.async_ps import (
    default_downpour_tx,
    init_downpour_accumulator,
    make_downpour_device_step,
)
from distributed_ml_pytorch_tpu_torch.training.trainer import (
    SGD,
    create_train_state,
    loss_and_grads,
    make_scan_accum_train_step,
    make_scan_train_step,
    make_train_step,
)
from distributed_ml_pytorch_tpu_torch.utils.devtime import device_time
from distributed_ml_pytorch_tpu_torch.utils.flops import (
    check_flops_agreement,
    cnn_train_flops,
    conv_linear_macs,
    lm_train_flops_6nd,
    utilization,
)

RESULTS: list = []

GPT2_SMALL = dict(vocab_size=50304, d_model=768, n_heads=12, n_layers=12, d_ff=3072)
#: the widths ``--tiny`` gives every LM leg
TINY_LM = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Rate(float):
    """tokens/s (or images/s) that also carries the leg's FLOPs story:
    ``.flops_per_step``, ``.tflops`` (achieved), ``.mfu`` (fraction of the
    card's ``.peak`` rate: bf16 unless the leg names another) — any may be
    None — and the ``.step_seconds``, timing ``.source`` and train-step kind
    it came from (the JAX bench.py's ``Rate``)."""

    flops_per_step: Optional[float] = None
    tflops: Optional[float] = None
    mfu: Optional[float] = None
    peak: str = "bf16"
    step_seconds: Optional[float] = None
    source: Optional[str] = None
    step_kind: Optional[str] = None

    @staticmethod
    def make(value: float, flops_per_step, step_seconds, device: Optional[str] = None,
             peak: str = "bf16") -> "Rate":
        r = Rate(value)
        r.flops_per_step = flops_per_step
        r.step_seconds = step_seconds
        r.peak = peak
        r.tflops, r.mfu = utilization(flops_per_step, step_seconds, device, peak)
        return r

    def mfu_note(self) -> str:
        """Human fragment for a note: '12.3 TFLOP/s, 6.2% MFU' (against the
        bf16 peak; another peak is named)."""
        if self.tflops is None:
            return "flops not counted"
        if self.mfu is None:
            return f"{self.tflops:.1f} TFLOP/s (no peak table for device)"
        of = "" if self.peak == "bf16" else f" of the {self.peak} peak"
        return f"{self.tflops:.1f} TFLOP/s, {self.mfu:.1%} MFU{of}"

    def record_fields(self) -> dict:
        """The FLOPs story as JSON record fields."""
        rec = {}
        if self.tflops is not None:
            rec["flops_per_step"] = self.flops_per_step
            rec["tflops"] = round(self.tflops, 2)
            if self.mfu is not None:
                rec["mfu"] = round(self.mfu, 4)
                rec["mfu_peak"] = self.peak
        return rec


def hardware(device: torch.device) -> str:
    """The record's hardware field: ``"1x <card name>"`` or ``"1x cpu"``."""
    if device.type == "cuda":
        return f"1x {torch.cuda.get_device_name(device)}"
    return "1x cpu"


def emit(config: int, metric: str, value: float, unit: str, hardware: str,
         note: str, extra: dict = None) -> dict:
    """Print one record as a JSON line (and keep it in ``RESULTS``)."""
    rec = {
        "config": config,
        "metric": metric,
        "value": round(float(value), 1),
        "unit": unit,
        "hardware": hardware,
        "note": note,
    }
    if isinstance(value, Rate) and value.tflops is not None:
        rec.update(value.record_fields())
        rec["note"] = f"{note}; {value.mfu_note()}"
    if extra:
        rec.update(extra)
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)
    return rec


# ------------------------------------------------------------------ LM legs

def bench_lm(lm: Optional[nn.Module] = None, batch: int = 1, seq: int = 8192,
             n_long: int = 11, cross_check: bool = True, tag: str = "lm",
             device="cuda") -> Rate:
    """Steady-state tokens/s (+ FLOPs/MFU) of one LM train step.

    ``lm`` defaults to ``TransformerLM(dtype=bfloat16, remat=False,
    pos_encoding="rope")`` on ``device``; a given model is timed where its
    parameters lie. ``max(2, n_long)`` steps are timed after two warm-up
    steps, each step's parameters feeding the next."""
    if lm is None:
        lm = TransformerLM(dtype=torch.bfloat16, remat=False, pos_encoding="rope",
                           device=resolve_device(device))
    dev = next(lm.parameters()).device
    lr = 1e-3  # ONE recipe for both step builders below: plain SGD at lr
    tx = SGD(lr)
    state = create_lm_train_state(lm, tx)
    tokens = np.random.default_rng(0).integers(
        0, lm.vocab_size, size=(batch, seq)).astype(np.int32)
    targets = torch.from_numpy(next_token_targets(tokens).astype(np.int64)).to(dev)
    tokens = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    if getattr(lm, "head", None) is True:
        # detachable-head models take the restructured lm_head step
        # (ops/fused_head.py): the same function as the AD step (tested), one
        # lse for loss, backward and update; plain SGD at lr, as tx
        step = make_fused_head_sgd_step(lm, lr)
        step_kind = "fused-head"
    else:
        step = make_fsdp_lm_train_step(lm, tx)
        step_kind = "AD"

    heads = lm.n_heads
    remat = bool(getattr(lm, "remat", False))
    n_params = sum(p.numel() for p in lm.parameters())
    embed_params = sum(p.numel() for name, p in lm.named_parameters()
                       if "embed" in name.lower())
    step_flops = lm_train_flops_6nd(n_params - embed_params, batch, seq, heads,
                                    lm.d_model // heads, lm.n_layers, causal=True, remat=remat)
    warn = None
    if cross_check:
        dense = sum(m.weight.numel() for m in lm.modules() if isinstance(m, nn.Linear))
        warn = check_flops_agreement(
            lm_train_flops_6nd(dense, batch, seq, heads, lm.d_model // heads, lm.n_layers,
                               causal=True, remat=remat), step_flops)
        if warn:
            log(f"{tag}: {warn}")

    holder = {"s": state}

    def one_step():
        holder["s"], loss = step(holder["s"], tokens, targets)
        return loss

    t = device_time(one_step, calls=max(2, n_long), warmup=2)
    per_step = t.per_call_s
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rate = Rate.make(batch * seq / per_step, step_flops, per_step, name)
    rate.source = t.source
    rate.step_kind = step_kind
    log(f"{tag} ({n_params / 1e6:.0f}M params, {step_kind} step): {per_step * 1e3:.1f} "
        f"ms/step at batch {batch} x seq {seq} -> {rate:.0f} tokens/s ({rate.mfu_note()}, "
        f"{t.source}; 6ND cross-check "
        f"{'skipped' if not cross_check else 'ok' if warn is None else 'FAILED'})")
    return rate


def _widths(lm) -> str:
    return f"{lm.d_model}d/{lm.n_heads}h/{lm.n_layers}L"


def lm_phase(device, tiny: bool = False) -> dict:
    """Config 6's three LM legs; returns ``{metric: Rate}``."""
    dev = resolve_device(device)
    hw = hardware(dev)
    if tiny:
        base, gpt2, long_seq, short_seq, batch = TINY_LM, TINY_LM, 64, 32, 2
        cut = f"--tiny: {TINY_LM}, seq {long_seq}/{short_seq}, batch {batch}; "
    else:
        base, gpt2, long_seq, short_seq, batch = {}, GPT2_SMALL, 8192, 2048, 8
        cut = ""
    how = "6ND FLOPs over the non-embedding parameters (no compiled count in PyTorch)"
    rates = {}
    default_lm = TransformerLM(**base, dtype=torch.bfloat16, remat=False, pos_encoding="rope",
                               device=dev)
    r = bench_lm(default_lm, batch=1, seq=long_seq, tag="lm-512d-seq8192")
    rates["transformer_lm_seq8192_train_throughput"] = r
    emit(6, "transformer_lm_seq8192_train_throughput", r, "tokens/sec/chip", hw,
        f"{cut}default TransformerLM ({_widths(default_lm)}), bf16 activations, no remat, "
        f"RoPE, batch 1 x seq {long_seq}, {r.step_kind} step, {r.step_seconds * 1e3:.3f} "
        f"ms/step ({r.source}); {how}")
    del default_lm
    lm = TransformerLM(**gpt2, dtype=torch.bfloat16, remat=False, pos_encoding="rope",
                       device=dev)
    for metric, b, s, tag in (
            ("gpt2_small_seq2048_train_throughput", batch, short_seq, "gpt2-small-seq2048"),
            ("gpt2_small_seq8192_train_throughput", 1, long_seq, "gpt2-small-seq8192")):
        r = bench_lm(lm, batch=b, seq=s, n_long=6, tag=tag)
        emit(6, metric, r, "tokens/sec/chip", hw,
            f"{cut}GPT-2-small config ({_widths(lm)}, padded vocab 50304), bf16, RoPE, "
            f"CUDA flash attention, batch {b} x seq {s}, {r.step_kind} step, "
            f"{r.step_seconds * 1e3:.3f} ms/step ({r.source}); {how}")
        rates[metric] = r
    return rates


# ------------------------------------------------------------------ config 1: AlexNet legs

ALEXNET_LR = 0.008
#: bench.py's steps a dispatch: SCAN_K for the batch-64 leg, LARGE_SCAN_K
#: for the batch-1024 legs (updates, for the accumulation leg)
SCAN_K, LARGE_SCAN_K = 100, 20
#: the accumulation leg: microbatch 256, each update the sum of batch-64
#: mean-gradient updates (bench.py's ACCUM_MICROBATCH, EFFECTIVE_UPDATE)
ACCUM_MICROBATCH, EFFECTIVE_UPDATE = 256, 64
#: (metric, batch, fused_epilogue, accumulate): bench.py's parity_b64,
#: large_batch_b1024 (also unfused) and grad_accum_b1024 legs
ALEXNET_LEGS = (
    ("alexnet_cifar10_train_throughput", 64, False, False),
    ("alexnet_cifar10_train_throughput_large_batch", 1024, True, False),
    ("alexnet_cifar10_train_throughput_large_batch_unfused", 1024, False, False),
    ("alexnet_cifar10_train_throughput_grad_accum", 1024, True, True),
)
#: the batches ``--tiny`` gives the legs, and its steps a dispatch
TINY_ALEXNET_BATCH = {64: 4, 1024: 8}
TINY_SCAN_K = 2
ALEXNET_NOTES = {
    (64, False): "reference recipe (batch 64, SGD lr 0.008), the trajectory-parity leg",
    (1024, False): "identical architecture at batch 1024, the headline leg",
    (1024, True): "batch 1024 as a microbatch-{m} accumulation whose update is the sum of "
                  "the batch-{e} mean-gradient updates at frozen params (large-batch "
                  "geometry, batch-{e}-recipe effective update)",
}


def make_batch(batch: int, seed: int = 0, k: int = 0, shape: tuple = (32, 32, 3),
               n_classes: int = 10):
    """Synthetic image batch as the JAX ``bench.py::make_batch`` makes one:
    normal images from ``default_rng(seed)``, labels ``arange % n_classes``
    (int64, torch's class index type); ``k > 0`` stacks k distinct batches on
    a leading axis (for the K-step trainers)."""
    rng = np.random.default_rng(seed)
    n = (k or 1) * batch
    images = rng.normal(size=(n, *shape)).astype(np.float32)
    labels = (np.arange(n) % n_classes).astype(np.int64)
    if k:
        return images.reshape(k, batch, *shape), labels.reshape(k, batch)
    return images, labels


def alexnet_step(batch: int, fused: bool, device="cuda", downpour: bool = False):
    """``step() -> loss``: one SGD step (lr 0.008) of a seed-0 AlexNet on one
    synthetic batch that stays on ``device``. ``downpour=True`` takes the
    DownPour worker's device step instead: the same forward and backward,
    then the local update accumulated by ``flat_axpy`` (K1)."""
    dev = resolve_device(device)
    model = get_model("alexnet", fused_epilogue=fused, seed=0, device=dev)
    images, labels = make_batch(batch)
    x = torch.from_numpy(images).to(dev)
    y = torch.from_numpy(labels).to(dev)
    if not downpour:
        tx = SGD(ALEXNET_LR)
        state = create_train_state(model, tx)
        train_step = make_train_step(model, tx)
        return lambda: train_step(state, x, y)[1]
    tx = default_downpour_tx(ALEXNET_LR)
    opt_state = tx.init(list(model.parameters()))
    _flat, n, pad, accum = init_downpour_accumulator(model)
    device_step = make_downpour_device_step(model, tx, n, pad)

    def step():
        loss = loss_and_grads(model, x, y)
        device_step(opt_state, accum)
        return loss

    return step


def alexnet_scan_step(batch: int, fused: bool, k: int, accumulate: bool = False,
                      microbatch: int = ACCUM_MICROBATCH, device="cuda"):
    """``dispatch() -> losses [k]``: one K-step dispatch of a seed-0 AlexNet
    (SGD lr 0.008) over k distinct batches of ``make_batch(batch, k=k)``
    that stay on ``device``: ``make_scan_train_step``, or with
    ``accumulate`` ``make_scan_accum_train_step(microbatch,
    effective_update_batch=EFFECTIVE_UPDATE)``. The state advances each
    dispatch."""
    dev = resolve_device(device)
    model = get_model("alexnet", fused_epilogue=fused, seed=0, device=dev)
    tx = SGD(ALEXNET_LR)
    state = create_train_state(model, tx)
    scan = (make_scan_accum_train_step(model, tx, microbatch,
                                       effective_update_batch=EFFECTIVE_UPDATE)
            if accumulate else make_scan_train_step(model, tx))
    images, labels = make_batch(batch, k=k)
    x = torch.from_numpy(images).to(dev)
    y = torch.from_numpy(labels).to(dev)
    return lambda: scan(state, x, y)[1]


def alexnet_phase(device, tiny: bool = False, warmup: int = 2, calls: int = 3) -> dict:
    """Config 1's AlexNet legs; returns ``{metric: Rate}``. Each leg trains a
    fresh seed-0 model, K steps (updates) a dispatch: ``warmup`` dispatches
    (the graph's warm-up and capture; the record keeps their losses), then
    ``calls`` dispatches timed by ``utils/devtime.device_time``."""
    dev = resolve_device(device)
    hw = hardware(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    macs = sum(conv_linear_macs(get_model("alexnet", device="cpu"), (1, 32, 32, 3)).values())
    if tiny:
        calls = 1
    rates = {}
    for metric, leg_batch, fused, accumulate in ALEXNET_LEGS:
        batch = TINY_ALEXNET_BATCH[leg_batch] if tiny else leg_batch
        k = TINY_SCAN_K if tiny else (SCAN_K if leg_batch == 64 else LARGE_SCAN_K)
        micro = batch // 4 if tiny else ACCUM_MICROBATCH
        dispatch = alexnet_scan_step(batch, fused, k, accumulate, micro, dev)
        losses = [float(v) for _ in range(warmup) for v in dispatch().cpu()]
        t = device_time(dispatch, calls=calls, warmup=1)
        per_step = t.per_call_s / k
        r = Rate.make(batch / per_step, cnn_train_flops(macs, batch), per_step, name,
                      peak="f32")
        r.source = t.source
        rates[metric] = r
        cut = f"--tiny: batch {batch} on the leg of batch {leg_batch}; " if tiny else ""
        note = ALEXNET_NOTES[(leg_batch, accumulate)].format(m=micro, e=EFFECTIVE_UPDATE)
        emit(1, metric, r, "images/sec/chip", hw,
             f"{cut}{note}; relu->pool epilogue "
             f"{'fused (relu_pool2 kernels)' if fused else 'unfused'}; full float32 (no TF32), "
             f"{k} {'updates' if accumulate else 'steps'} a dispatch (CUDA graph on the card, "
             f"a loop on the CPU), as the JAX harness scans them; {per_step * 1e3:.3f} "
             f"ms/{'update' if accumulate else 'step'} ({t.source}); FLOPs 6 x {macs} "
             f"conv/linear MACs an image, against the 67 TFLOP/s float32 non-tensor peak of "
             f"NVIDIA's H100 SXM data sheet",
             extra={"batch": batch, "fused_epilogue": fused, "steps_per_dispatch": k,
                    "microbatch": micro if accumulate else None,
                    "effective_update_batch": EFFECTIVE_UPDATE if accumulate else None,
                    "warmup_losses": losses,
                    "cudnn": {"deterministic": torch.backends.cudnn.deterministic,
                              "benchmark": torch.backends.cudnn.benchmark}})
    return rates


# ------------------------------------------------------------------ conv epilogue ladder

def compute_microbench_phase(device="cuda", batch: int = 256) -> dict:
    """Per-fusion cost ladder for the conv epilogues: the fused ``relu_pool2``
    and ``bias_relu`` ops against the unfused chains of plain PyTorch ops,
    standalone, on AlexNet's conv-output shapes at the large-batch leg's
    scale. On the card the fused ops run their kernels; on the CPU their
    plain versions (recorded as such). Returns ``{metric: {"fwd_us",
    "fwdbwd_us"}}`` unrounded."""
    dev = resolve_device(device)
    hw = hardware(dev)
    on_card = dev.type == "cuda"
    path = "cuda kernel" if on_card else "plain version (cpu)"
    calls = 10 if on_card else 3
    b = batch
    rng = np.random.default_rng(0)
    shapes = {  # AlexNet conv outputs feeding a relu->pool tail
        "conv1_tail": (b, 8, 8, 64),
        "conv2_tail": (b, 4, 4, 192),
        "conv5_tail": (b, 2, 2, 256),
    }

    def tensor(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def us(t):
        return t.per_call_s * 1e6

    def fwdbwd(fn, x, ct, *rest):
        def call():
            v = x.detach().requires_grad_(True)
            return torch.autograd.grad(fn(v, *rest), v, ct)[0]
        return call

    out = {}
    for name, shape in shapes.items():
        x = tensor(shape)
        ct = tensor((shape[0], shape[1] // 2, shape[2] // 2, shape[3]))
        variants = {
            "unfused": lambda v: fc.max_pool_2x2(F.relu(v)),
            "fused": fc.relu_pool2,
        }
        costs = {}
        for tag, fn in variants.items():
            t_f = device_time(fn, x, calls=calls, warmup=1)
            t_fb = device_time(fwdbwd(fn, x, ct), calls=calls, warmup=1)
            costs[tag] = (us(t_f), us(t_fb))
            metric = f"conv_epilogue_{name}_{tag}_fwdbwd"
            out[metric] = {"fwd_us": us(t_f), "fwdbwd_us": us(t_fb)}
            emit(1, metric, us(t_fb), "us/call", hw,
                 f"{name} {shape} relu->2x2pool {tag} "
                 f"({path if tag == 'fused' else 'plain ops'}): fwd {us(t_f):.3f} us, "
                 f"fwd+bwd {us(t_fb):.3f} us ({t_fb.source})")
        log(f"  {name}: unfused fwd+bwd {costs['unfused'][1]:.1f} us vs "
            f"fused {costs['fused'][1]:.1f} us")

    # the elementwise bias+relu epilogue (conv3/conv4-shaped tail)
    x = tensor((b * 4 * 4, 384))
    bias = tensor((384,))
    ct = tensor(x.shape)
    for tag, fn in {
        "unfused": lambda v, bb: F.relu(v + bb),
        "fused": fc.bias_relu,
    }.items():
        t_f = device_time(fn, x, bias, calls=calls, warmup=1)
        t_fb = device_time(fwdbwd(fn, x, ct, bias), calls=calls, warmup=1)
        metric = f"conv_epilogue_bias_relu_{tag}_fwdbwd"
        out[metric] = {"fwd_us": us(t_f), "fwdbwd_us": us(t_fb)}
        emit(1, metric, us(t_fb), "us/call", hw,
             f"bias+relu on {tuple(x.shape)} {tag} "
             f"({path if tag == 'fused' else 'plain ops'}): fwd {us(t_f):.3f} us, "
             f"fwd+bwd {us(t_fb):.3f} us ({t_fb.source})")
    return out


# ------------------------------------------------------------------ config 3: the PS world

#: ps_phase: workers, synthetic images a worker (JAX bench_all.py:823-824)
PS_WORKERS, PS_PER_WORKER = 4, 512
#: the card-worker leg's recipe (JAX bench_all.py:1602-1607)
PS_CARD_BATCH, PS_CARD_TRAIN, PS_CARD_EPOCHS = 64, 16384, 2
#: ``--tiny``: LeNet, images a worker, and the card leg's batch and images
TINY_PS_PER_WORKER, TINY_PS_CARD_BATCH, TINY_PS_CARD_TRAIN = 64, 16, 512


def _steady_rate_from_csv(path: str, batch: int):
    """Steady images/s from a trainer CSV's per-step timestamps: ``batch``
    over the MEAN gap between consecutive records over the second half of
    the run (warm-up and compile excluded), as the JAX function computes it
    with pandas. Mean, not median: a chunked worker logs its steps in bursts
    at each loss read, so the gaps are ~0 within a burst. Returns
    ``(images_per_s, n_records)``, or ``None`` for a missing file, fewer
    than 8 records or no positive mean."""
    if not os.path.isfile(path):
        return None
    with open(path, newline="") as fh:
        stamps = [datetime.fromisoformat(row["timestamp"]) for row in csv.DictReader(fh)]
    if len(stamps) < 8:
        return None
    gaps = [(b - a).total_seconds() for a, b in zip(stamps, stamps[1:])]
    tail = gaps[len(gaps) // 2:]
    per_step = sum(tail) / len(tail)
    if per_step <= 0:
        return None
    return batch / per_step, len(stamps)


def _ps_args(dev, tiny: bool) -> list:
    return ["--backend", dev.type, "--synthetic-data", "--synthetic-test-size", "64",
            "--test-batch-size", "64", "--log-interval", "100000",
            *(["--model", "lenet"] if tiny else [])]


def ps_phase(device, tiny: bool = False) -> dict:
    """Config 3's legs as processes; returns ``{metric: value}``. Every
    process that exits non-zero fails the leg (raises)."""
    from distributed_ml_pytorch_tpu_torch.launch import launch_world

    dev = resolve_device(device)
    hw = hardware(dev)
    base = _ps_args(dev, tiny)
    cut = "--tiny: LeNet; " if tiny else ""
    out = {}
    per_worker = TINY_PS_PER_WORKER if tiny else PS_PER_WORKER
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        code = launch_world(PS_WORKERS + 1, [*base, "--epochs", "1", "--log-dir", td,
                                             "--synthetic-train-size", str(per_worker)])
        dt = time.perf_counter() - t0
    if code != 0:
        raise RuntimeError(f"config 3's {PS_WORKERS}-worker world exited with code {code}")
    out["async_ps_4worker_aggregate_throughput"] = agg = PS_WORKERS * per_worker / dt
    emit(3, "async_ps_4worker_aggregate_throughput", agg, "images/sec",
         f"{hw}, {PS_WORKERS + 1} processes",
         f"{cut}{PS_WORKERS} workers x {per_worker} images in {dt:.1f}s wall, startup, "
         "build and capture included (the reference's launch pattern); TCP, transport "
         "auto, batch 64, n_push = n_pull = 10")
    batch = TINY_PS_CARD_BATCH if tiny else PS_CARD_BATCH
    recipe = [*base, "--batch-size", str(batch), "--epochs", str(PS_CARD_EPOCHS),
              "--synthetic-train-size", str(TINY_PS_CARD_TRAIN if tiny else PS_CARD_TRAIN)]
    with tempfile.TemporaryDirectory() as td:
        code = launch_world(2, [*recipe, "--chunked-dispatch", "on", "--log-dir", td])
        got = _steady_rate_from_csv(os.path.join(td, "node1.csv"), batch)
        if code != 0 or got is None:
            raise RuntimeError(f"the one-worker world exited with code {code} ({got})")
        out["async_ps_gpu_worker_throughput"], n = got
        emit(3, "async_ps_gpu_worker_throughput", got[0], "images/sec/chip",
             f"{hw}: a host server process + 1 worker process",
             f"{cut}steady state from {n} per-step CSV timestamps; DownPour cadence 10/10 "
             "with chunked dispatch (each run of local steps replays one captured step)")
    with tempfile.TemporaryDirectory() as td:
        code = subprocess.run(
            [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.training.cli",
             "--no-distributed", "--steps-per-dispatch", "10", "--log-dir", td, *recipe],
            env=dict(os.environ)).returncode
        name = "gpu.csv" if dev.type == "cuda" else "single.csv"
        got = _steady_rate_from_csv(os.path.join(td, name), batch)
        if code != 0 or got is None:
            raise RuntimeError(f"the single-mode leg exited with code {code} ({got})")
        out["single_mode_scanned_throughput"], n = got
        emit(3, "single_mode_scanned_throughput", got[0], "images/sec/chip", hw,
             f"{cut}same recipe at --steps-per-dispatch 10 (the chunk size the PS cadence "
             f"implies), {n} per-step records")
    overhead = 100 * (1 - out["async_ps_gpu_worker_throughput"]
                      / out["single_mode_scanned_throughput"])
    out["async_ps_push_pull_overhead"] = overhead
    emit(3, "async_ps_push_pull_overhead", overhead, "percent", "derived",
         f"{cut}throughput cost of the PS protocol for a card worker against the same "
         "recipe scanned in single mode (each rate from its CSV)")
    return out


LEGS = {
    "alexnet": lambda dev, tiny: alexnet_phase(dev, tiny=tiny),
    "lm": lambda dev, tiny: lm_phase(dev, tiny=tiny),
    "conv_epilogue": lambda dev, tiny: compute_microbench_phase(dev, batch=16 if tiny else 256),
    "ps": lambda dev, tiny: ps_phase(dev, tiny=tiny),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", default=",".join(LEGS),
                    help=f"comma-separated legs to run, in order (of {', '.join(LEGS)})")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or on the CPU")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink every leg to test widths (for a CPU run)")
    args = ap.parse_args(argv)
    legs = [leg for leg in args.legs.split(",") if leg]
    unknown = [leg for leg in legs if leg not in LEGS]
    if unknown or not legs:
        ap.error(f"unknown or no legs {unknown} (choose from {', '.join(LEGS)})")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        full_float32()
    for leg in legs:
        LEGS[leg](dev, args.tiny)
    log(f"bench_all: {len(RESULTS)} measurements")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
