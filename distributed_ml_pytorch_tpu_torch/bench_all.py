"""The legs of the JAX ``bench_all.py`` that the port runs on the card.

    python -m distributed_ml_pytorch_tpu_torch.bench_all                    # every leg, on the card
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs alexnet
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs conv_epilogue
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs ps
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs sharded_ps,transport
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs lm_32k,steps_to_accuracy,reliability
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs wire_bytes
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs elastic
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs recovery,coordfail,health
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs sched
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs gray
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs resnet,moe,decode
    python -m distributed_ml_pytorch_tpu_torch.bench_all --legs mesh --device cpu
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
  and ``async_ps_push_pull_overhead``; then the worker's device cycle (JAX
  ``_ps_device_cycle_phase``, :1649): one 1 + 9 cadence cycle of chunked
  dispatches (one captured DownPour step replayed, K1 inside the graph) of
  an unfused AlexNet at batch 64, 10 cycles with no host fetch but a
  trailing loss read, on device-resident and then on host batches, as
  ``async_ps_chunked_device_cycle``.
- ``sharded_ps`` — config 3's sharded leg (JAX ``sharded_ps_phase``,
  bench_all.py:946, and ``bench_sharded_push_rtt``, :859): the per-shard
  apply (``ParameterServer.handle`` of one push on the first of k slices of
  AlexNet's flat vector, 50 repetitions) at k in {1, 2, 4} as
  ``sharded_ps_per_shard_apply_k{k}``; the round trip of pushing every
  shard its slice of a full 9.9 MB gradient, asking every slice back and
  waiting for all k replies, against k shard server processes over TCP, 20
  rounds after 3 of warm-up, as ``sharded_ps_e2e_push_rtt_k{1,2}``; and
  worlds of k shard servers and 2 AlexNet workers (on the card unless
  ``--device cpu``), 384 images a worker at batch 16, as
  ``sharded_ps_k{k}_aggregate_throughput`` from the wall time with start-up
  included. ``--tiny`` shrinks the image counts only.
- ``transport`` — config 7's wire leg (JAX ``transport_phase``,
  bench_all.py:1719): round trips a second of a 9.9 MB payload echoed by a
  second process, over the native transport and over the Python one, as
  ``ps_transport_roundtrip_{native,python}``, 30 after 2 of warm-up.
- ``reliability`` — config 7's reliability leg (JAX ``reliability_phase``,
  :1773): the Python-TCP echo of the same payload with the reliable layer
  off, on the older envelope (``legacy_envelope=True``) and on the current
  one, interleaved over 4 rounds, each mode's best median round trip, as
  ``ps_transport_roundtrip_python_acks_{off,legacy,on}``,
  ``ps_reliability_layer_overhead`` and ``ps_reliability_ack_tax_recovered``.
- ``lm_32k`` — config 6's long-context leg (JAX ``bench_lm_32k``, :589):
  GPT-2-small (bf16, RoPE, remat) on one 32768-token sequence, the loss in
  2048-token chunks, SGD lr 1e-3, as ``gpt2_small_seq32768_train_throughput``;
  the size rule keeps the fused backward (K5) at this shape.
- ``steps_to_accuracy`` — config 1's north-star metric 2 (JAX
  ``bench_steps_to_accuracy``, :354, emitted at :168): the reference recipe
  on the synthetic set and the JAX harness's index stream, 25 steps a
  dispatch and an eval after each, as ``steps_to_99pct_test_accuracy`` (-1
  at the 2000-step cap, with the final accuracy and the per-eval curve).
  The matched-init ratio (:191) needs JAX's init on the card and is not
  emitted.
- ``wire_bytes`` — config 7's compressed-wire ladder (JAX
  ``wire_bytes_phase``, bench_all.py:2229-2452): the exact frame bytes of
  one dense, int8 and top-k push of AlexNet's 2,472,266-float vector, and
  acked pushes a second on an in-process reliable world whose real
  ``ParameterServer`` decodes and applies every frame (the encoder's and
  the decoder's host time inside the loop), as
  ``ps_wire_bytes_per_push_{mode}``, ``ps_push_roundtrips_{mode}`` and
  ``ps_wire_compression_ratio_{int8,topk}``; the dense and int8 rungs of
  the activation and KV-migration planes through ``utils/codecs`` as
  ``{act,kv_migrate}_wire_bytes_per_frame_{mode}``,
  ``{act,kv_migrate}_codec_frames_per_s_{mode}`` and their int8 ratios; and
  the pull-reply ladder through the server's real delta-reply path (a held
  stamp in, a ``DeltaParams`` frame out, a ``Listener`` install) as
  ``pull_reply_bytes_{full,delta_steady}``,
  ``pull_reply_roundtrips_delta`` and
  ``pull_reply_compression_ratio_delta``. Host work only: it runs the same
  on the CPU. A failed rung raises.
- ``conv_epilogue`` — config 1's conv-epilogue ladder (JAX
  ``compute_microbench_phase``, bench_all.py:2000-2073): ``relu_pool2``
  fused against ``max_pool_2x2(relu(x))`` on AlexNet's three relu->pool
  tails at batch 256, and ``bias_relu`` fused against ``relu(x + b)`` on a
  (4096, 384) tail, forward and forward+backward.
- ``elastic`` — config 3's elastic leg (JAX ``elastic_phase``,
  bench_all.py:1045-1102): worker 1's images/s before, during and after a
  coordinator-driven rebalance of an in-process fleet
  (``coord/demo.elastic_scenario``: two elastic shard servers, two LeNet
  workers on the card, batch 16, cadence 2/2, lease 0.4 s, 72 steps, shard
  2 crashing at step 24), as
  ``elastic_rebalance_throughput_{before,during,after}``; host clock.
- ``recovery``, ``coordfail``, ``health`` — config 3's durability and
  health legs (JAX ``recovery_phase``, ``coordfail_phase``,
  bench_all.py:1105-1188, and ``health_phase``, :1509-1580), each one
  in-process fleet of two elastic shard servers and two LeNet workers on
  the card at the scenario's defaults, seed 0: ``coord/drill.
  recovery_drill`` under its default plan as ``recovery_mttr`` (every shard
  killed, to every restored shard serving pulls again) and
  ``recovery_restore`` (manifest load, checkpoint restore, WAL replay and
  dedup seed of both shards); ``coord/drill.coordfail_drill(kill_during=
  "snapshot")`` as ``coordfail_mttr`` (the coordinator killed mid-barrier,
  to every member re-attached to the new life) and ``coordfail_restore``
  (the epoch bump, checkpoint load and log replay), the worker steps lost
  in the note; ``coord/health.health_scenario`` as ``health_reject_rate``
  (quarantined of arriving pushes, %), ``health_nack_roundtrips`` (nacks
  the workers heard) and ``health_rollback_mttr`` (the watchdog's barrier
  to every shard's ``RollbackDone``); host clock.
- ``sched`` — config 3's scheduler leg (JAX ``sched_phase``,
  bench_all.py:1308-1402): ``coord/drill.sched_drill`` at seed 0 under the
  default drill plan (two elastic shard servers, two LeNet workers on the
  card, a training and a serving tenant): ``sched_preempt_mttr`` (the
  serving spike's snapshot barrier, ``PreemptRequest`` and park, to the
  slot granted away) and ``sched_resume_mttr`` (the off-peak revoke to the
  shard's new life rejoined, restored bit for bit), and
  ``sched_goodput_uplift``: useful slot-seconds of the shared fleet against
  two static half-fleets over the same measured day, the borrowed slot's
  serving priced at the rate of a real ``ServingEngine`` burst
  (:func:`_serving_slot_rate`, JAX :1277-1306: vocab 128, d 64, 2 heads, 2
  layers, 4 slots, 8 requests of 24 tokens; K8 on the card); host clock.
- ``gray`` — config 3's gray-failure leg (JAX ``gray_phase``,
  bench_all.py:1190-1275): ``coord/drill.gray_drill`` at seed 0 twice over
  the same windowed one-way partition (two elastic shard servers, two
  LeNet workers, 170 fixed steps), contained and unmanaged:
  ``gray_victim_slice_goodput_contained`` and ``_unmanaged`` (the updates
  the gray shard applied per second of the day), ``gray_detect_latency``
  (the onset to probation) and ``gray_containment_mttr`` (probation to
  parked), in ms; the detection latency is held to
  ``gray_detection_latency_ceiling_s`` of the root ``bench_floors.json``.
  Host clock: the figures are the in-process fleet's host timing, not the
  card's.

- ``mpmd`` — config 3's MPMD pipeline leg (JAX ``mpmd_phase``,
  bench_all.py:1405-1506): ``coord/stages.mpmd_scenario`` at seed 0 (4
  stage members as threads, M = 4 microbatches of 4 x 8 tokens, the
  scenario's default widths, on the reliable in-process wire), a warm-up
  run, then 16 fault-free steps as ``mpmd_pipeline_steady`` (tokens/s
  between the first and last step completions) and
  ``mpmd_bubble_fraction`` (1 - the stages' busy seconds / (stages x
  wall)), then the middle stage killed at step 6 and restarted from its
  checkpoint: ``mpmd_stage_restart_mttr`` (the vacancy, ms) and
  ``mpmd_stage_kill_throughput_{before,during,after}``. The
  ``mpmd_bubble_fraction`` record carries ``bubble_attribution``: the
  steady run's flight-recorder dumps merged by ``analysis/timeline.py``,
  each stage's wall clock split over its exclusive states and checked by
  :func:`check_bubble_attribution`. Host clock. ``--tiny``: 8 steps, the kill at step 3.
- ``resnet`` — configs 4 and 5 (JAX bench_all.py:207-248, ``bench_jax``
  and ``bench_hostfed_resnet50``, :758): seed-0 GroupNorm ResNets trained
  by ``make_scan_train_step`` (SGD lr 0.008, K steps a dispatch: a CUDA
  graph on the card) on ``make_batch`` images — ResNet-18 on CIFAR shapes
  in float32 at b64 (K 20) and bf16 at b256 (K 10), ResNet-50 at 224² with
  1000 classes in float32 at b32 (K 4) and bf16 at b256 (K 2) — as
  ``resnet18_cifar10_train_throughput[_bf16]`` and
  ``resnet50_imagenet_shape_train_throughput[_bf16]``, FLOPs 6 x the
  conv/linear MACs an image; then ``resnet50_hostfed_overlapped_input_
  throughput``: ResNet-50 bf16 b256, each step's batch copied from pinned
  host memory on a side stream while the previous step runs (host clock).
- ``moe`` — config 6's MoE leg (JAX ``bench_moe_lm``, :652): the Switch-MoE
  LM at GPT-2-small widths, 4 experts top-1, capacity 2.0, bf16, 8 x 2048,
  the AD step (no detachable head), as
  ``moe_lm_4expert_seq2048_train_throughput``; FLOPs the products run
  (``utils/flops.moe_lm_train_flops``), not 6ND over every expert.
- ``decode`` — config 8 (JAX ``bench_decode``, :673-755): GPT-2-small
  (bf16, learned positions) ``generate()`` at b32, prompt 128, 256 new
  tokens, greedy (the blocked path, K8), two calls after a warm-up timed by
  :func:`timed_generate` (``chip_smoke.py`` phase 8's timing), as
  ``gpt2_small_decode_throughput``, ``gpt2_small_decode_hbm_utilization``
  (a step's mandatory bytes x steps/s over a streaming read measured on
  the same device) and ``gpt2_small_decode_throughput_int8_kv``.

- ``mesh`` — the JAX ``cpu_mesh_phase`` and ``multiprocess_psum_phase``
  (bench_all.py:2076-2220), off the card as the JAX legs were off the TPU
  (virtual CPU devices and CPU processes there): the raveled AlexNet
  gradient's ``all_reduce`` between two gloo ranks that are threads
  (``allreduce_2way_gradient_exchange_rate``, exchanges/s), a ResNet-18
  sync-DP step of global batch 64 over eight gloo ranks that are threads
  (``resnet18_8way_dp_step_throughput``, images/s) and the same
  ``all_reduce`` across four gloo processes, its sum checked
  (``allreduce_4process_gloo_exchange_rate``, the slowest rank's rate).
  ``--tiny``: fewer rounds, ResNet-18 at global batch 8.

``--tiny`` shrinks every other leg to test widths (a CPU run in seconds);
its records keep the metric names and say so in their notes. The
``recovery``, ``coordfail``, ``health``, ``sched`` and ``gray`` legs run their LeNet
fleet with or without it. Timing is
``utils/devtime.device_time``: CUDA events on the card, wall clock on the
CPU (the record's note names the source). The LM legs' FLOP numerator is
``utils/flops.lm_train_flops_6nd`` over the non-embedding parameters (XLA's
``compiled_flops`` has no PyTorch counterpart); the cross-check holds it
against the same count over the ``nn.Linear`` weights. Not ported yet: every
other phase of the JAX harness (``ROADMAP.md`` Queue A).
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
from distributed_ml_pytorch_tpu_torch.models import MoETransformerLM, TransformerLM, get_model
from distributed_ml_pytorch_tpu_torch.models.generate import generate
from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
from distributed_ml_pytorch_tpu_torch.ops.fused_head import make_fused_head_sgd_step
from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
    create_lm_train_state,
    next_token_targets,
)
from distributed_ml_pytorch_tpu_torch.parallel.async_ps import (
    ParameterServer,
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
from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params
from distributed_ml_pytorch_tpu_torch.utils.flops import (
    check_flops_agreement,
    cnn_train_flops,
    conv_linear_macs,
    lm_train_flops_6nd,
    moe_lm_train_flops,
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


#: the exclusive serve-loop states a ``bubble_attribution`` may name (the
#: mpmd plane's ``utils/obs.StateClock`` vocabulary)
BUBBLE_STATES = ("compute", "wait-act", "wait-grad", "wire-blocked", "ckpt", "idle")


def check_bubble_attribution(attr: dict) -> dict:
    """The schema gate of the ``mpmd`` leg's ``bubble_attribution``:
    fractions over the known exclusive states summing to about 1, and a
    ``bubble_fraction`` equal to ``1 - compute``. Raises ``ValueError`` on
    any breach: a malformed attribution must not ship in a record."""
    if not isinstance(attr, dict):
        raise ValueError(f"bubble_attribution must be a dict, got {type(attr).__name__}")
    fractions = attr.get("fractions")
    if not isinstance(fractions, dict) or not fractions:
        raise ValueError("bubble_attribution.fractions missing/empty")
    unknown = sorted(k for k in fractions if k not in BUBBLE_STATES)
    if unknown:
        raise ValueError(f"bubble_attribution names unknown state(s) {unknown} "
                         f"(known: {list(BUBBLE_STATES)})")
    total = sum(float(v) for v in fractions.values())
    if not 0.95 <= total <= 1.05:
        raise ValueError(f"bubble_attribution fractions sum to {total:.4f}, not ~1 — the "
                         "exclusive-state clock contract is broken")
    bubble = attr.get("bubble_fraction")
    if not isinstance(bubble, (int, float)) or not 0.0 <= bubble <= 1.0:
        raise ValueError(f"bubble_fraction {bubble!r} not in [0, 1]")
    if abs((1.0 - float(fractions.get("compute", 0.0))) - float(bubble)) > 1e-3:
        raise ValueError("bubble_fraction != 1 - compute fraction")
    stages = attr.get("stages")
    if not isinstance(stages, int) or stages < 1:
        raise ValueError(f"bubble_attribution.stages {stages!r} invalid")
    return attr


# ------------------------------------------------------------------ LM legs

def bench_lm(lm: Optional[nn.Module] = None, batch: int = 1, seq: int = 8192,
             n_long: int = 11, cross_check: bool = True, tag: str = "lm",
             device="cuda", flops: Optional[float] = None) -> Rate:
    """Steady-state tokens/s (+ FLOPs/MFU) of one LM train step.

    ``lm`` defaults to ``TransformerLM(dtype=bfloat16, remat=False,
    pos_encoding="rope")`` on ``device``; a given model is timed where its
    parameters lie. ``max(2, n_long)`` steps are timed after two warm-up
    steps, each step's parameters feeding the next. ``flops`` replaces the
    6ND numerator (a MoE model counts the products it runs)."""
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
    step_flops = flops or lm_train_flops_6nd(n_params - embed_params, batch, seq, heads,
                                             lm.d_model // heads, lm.n_layers, causal=True,
                                             remat=remat)
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


#: the long-context leg (JAX ``bench_lm_32k``, bench_all.py:589-650): one
#: sequence of S tokens, the loss in chunks of LM_32K_CHUNK tokens
LM_32K_SEQ, LM_32K_CHUNK = 32768, 2048
#: ``--tiny``: the sequence and the loss chunk
TINY_32K_SEQ, TINY_32K_CHUNK = 256, 64


def lm_32k_phase(device, tiny: bool = False) -> Rate:
    """Config 6's long-context leg, as the JAX recipe runs it: GPT-2-small
    (bfloat16, RoPE, ``remat=True``, ``max_len = S``) trained on one
    ``(1, S)`` sequence, tokens from ``default_rng(0)`` and targets from
    ``default_rng(1)``, plain SGD at lr 1e-3, the loss sequence-chunked
    (``training/trainer.chunked_lm_loss``, chunk 2048); two steps timed after
    two warm-up steps. At S = 32768 the flash size rule keeps the fused
    backward (its dQ-partials count is half the cap), so the step runs K4
    (forward and remat recompute) and K5. The record carries every step's
    loss; returns the rate."""
    dev = resolve_device(device)
    widths, seq, chunk = ((TINY_LM, TINY_32K_SEQ, TINY_32K_CHUNK) if tiny
                          else (GPT2_SMALL, LM_32K_SEQ, LM_32K_CHUNK))
    lm = TransformerLM(**widths, max_len=seq, dtype=torch.bfloat16, pos_encoding="rope",
                       remat=True, seed=0, device=dev)
    vocab = widths["vocab_size"]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, vocab, (1, seq))).to(dev)
    targets = torch.from_numpy(np.random.default_rng(1).integers(0, vocab, (1, seq))).to(dev)
    tx = SGD(1e-3)
    holder = {"s": create_lm_train_state(lm, tx), "losses": []}
    step = make_fsdp_lm_train_step(lm, tx, loss_chunk=chunk)

    def call():
        holder["s"], loss = step(holder["s"], tokens, targets)
        holder["losses"].append(loss)
        return loss

    t = device_time(call, calls=2, warmup=2)
    losses = [float(v) for v in holder["losses"]]
    n_params = sum(p.numel() for p in lm.parameters())
    embed_params = sum(p.numel() for name, p in lm.named_parameters()
                       if "embed" in name.lower())
    flops = lm_train_flops_6nd(n_params - embed_params, 1, seq, lm.n_heads,
                               lm.d_model // lm.n_heads, lm.n_layers, remat=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rate = Rate.make(seq / t.per_call_s, flops, t.per_call_s, name)
    rate.source = t.source
    cut = f"--tiny: {TINY_LM}, seq {seq}, loss chunk {chunk}; " if tiny else ""
    log(f"lm-32k: {t.per_call_s * 1e3:.1f} ms/step at batch 1 x seq {seq} -> {rate:.0f} "
        f"tokens/s ({rate.mfu_note()}, {t.source})")
    emit(6, "gpt2_small_seq32768_train_throughput", rate, "tokens/sec/chip", hardware(dev),
         f"{cut}FULL-model single-card training at {seq} tokens of context "
         f"({_widths(lm)}, bf16, RoPE, remat, loss in {chunk}-token chunks: the dense loss's "
         f"logits alone would be 1 x {seq} x {vocab}); CUDA flash attention, the fused "
         f"backward (K5) by the size rule; {t.per_call_s * 1e3:.3f} ms/step ({t.source}); "
         "6ND FLOPs over the non-embedding parameters, remat recompute included",
         extra={"batch": 1, "seq": seq, "loss_chunk": chunk, "losses": losses})
    return rate


# ------------------------------------------------------------------ config 6 MoE, config 8 decode

#: the MoE leg (JAX ``bench_moe_lm``, bench_all.py:652-670): GPT-2-small
#: widths, 4 experts, top-1, capacity factor 2.0, bf16, batch x seq
MOE_EXPERTS, MOE_CAPACITY, MOE_BATCH, MOE_SEQ = 4, 2.0, 8, 2048
TINY_MOE_BATCH, TINY_MOE_SEQ = 2, 128


def moe_lm_flops(moe, batch: int, seq: int) -> float:
    """:func:`utils.flops.moe_lm_train_flops` of ``moe`` at ``batch x seq``."""
    return moe_lm_train_flops(batch, seq, moe.vocab_size, moe.d_model, moe.n_heads,
                              moe.n_layers, moe.d_ff, moe.n_experts,
                              moe.blocks()[0].moe.capacity(seq), remat=moe.remat)


def moe_phase(device, tiny: bool = False) -> Rate:
    """Config 6's MoE leg: a ``MoETransformerLM`` at GPT-2-small widths
    (768d, 12 heads, 12 layers, d_ff 3072, vocab 50304, learned positions),
    4 experts top-1 at capacity factor 2.0, bf16, trained by the AD step
    (``bench_lm``: it has no detachable head) at 8 x 2048, its attention
    through K4 and K5 by the size rule. FLOPs are the products the step runs
    (``moe_lm_flops``), dispatch and combine included."""
    dev = resolve_device(device)
    widths, batch, seq = ((TINY_LM, TINY_MOE_BATCH, TINY_MOE_SEQ) if tiny
                          else (GPT2_SMALL, MOE_BATCH, MOE_SEQ))
    moe = MoETransformerLM(**widths, n_experts=MOE_EXPERTS, capacity_factor=MOE_CAPACITY,
                           max_len=seq, dtype=torch.bfloat16, seed=0, device=dev)
    r = bench_lm(moe, batch=batch, seq=seq, n_long=4, cross_check=False,
                 tag=f"moe-4e-seq{seq}", flops=moe_lm_flops(moe, batch, seq))
    cap = moe.blocks()[0].moe.capacity(seq)
    cut = f"--tiny: {widths}, batch {batch} x seq {seq}; " if tiny else ""
    emit(6, "moe_lm_4expert_seq2048_train_throughput", r, "tokens/sec/chip", hardware(dev),
         f"{cut}Switch-MoE ({_widths(moe)}, {MOE_EXPERTS} experts top-1, {MOE_CAPACITY} "
         f"capacity: {cap} slots an expert and sequence), bf16 activations over float32 "
         f"parameters (the expert products and the combine in float32, as the JAX model's "
         f"einsums promote them), learned positions, batch {batch} x seq {seq}, "
         f"{r.step_kind} step, {r.step_seconds * 1e3:.3f} ms/step ({r.source}); FLOPs the "
         "products run (projections, router, dispatch, experts over every slot, combine, "
         "attention, lm_head), not 6ND over every expert's parameters",
         extra={"batch": batch, "seq": seq, "n_experts": MOE_EXPERTS, "capacity": cap})
    return r


#: config 8's decode leg (JAX ``bench_decode``, bench_all.py:673-755):
#: GPT-2-small bf16, learned positions, batch 32, prompt 128, 256 new tokens
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 32, 128, 256
TINY_DECODE_BATCH, TINY_DECODE_PROMPT, TINY_DECODE_NEW = 2, 8, 33
#: elements of the streaming read that measures the card's memory rate
#: (256 MB of bf16, as JAX reads it), and ``--tiny``'s
STREAM_ELEMS, TINY_STREAM_ELEMS = 128 * 1024 * 1024, 1 << 20


def timed_generate(model, prompt, new_tokens: int, kv_quant: bool = False):
    """``(tokens, seconds)`` of one greedy ``generate()`` call on the host
    clock, the card synchronized before and after (the decode path's own
    pace: it is host-bound on the card)."""
    dev = prompt.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = generate(model, prompt, new_tokens, kv_quant=kv_quant)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def stream_bytes_per_s(device, elems: int = STREAM_ELEMS) -> float:
    """The memory rate a streaming read sustains on ``device``: a float32
    sum of ``elems`` bf16 ones, timed by ``utils/devtime.device_time``."""
    x = torch.ones(elems, dtype=torch.bfloat16, device=device)
    t = device_time(lambda: torch.sum(x, dtype=torch.float32), calls=6, warmup=2)
    return 2 * elems / t.per_call_s


def bench_decode(device, tiny: bool = False, kv_quant: bool = False, stream_bw=None):
    """Decode tokens/s of GPT-2-small (bf16, learned positions, seed 0)
    through ``generate()`` (greedy; the blocked path, K8 in every step) on
    prompts from ``default_rng(s)``, s = 0..7 in turn: two timed calls after
    a warm-up, each its prefill and ``new`` tokens (:func:`timed_generate`).
    Returns ``(tokens/s, share of the measured streaming rate, bytes a step,
    the rate)``: a step must read every parameter once in bf16 and the
    average live K/V (int8 values and f32 scales under ``kv_quant``), as the
    JAX leg counts them."""
    dev = resolve_device(device)
    widths, batch, plen, new = ((TINY_LM, TINY_DECODE_BATCH, TINY_DECODE_PROMPT,
                                 TINY_DECODE_NEW) if tiny
                                else (GPT2_SMALL, DECODE_BATCH, DECODE_PROMPT, DECODE_NEW))
    lm = TransformerLM(**widths, max_len=plen + new, dtype=torch.bfloat16,
                       pos_encoding="learned", seed=0, device=dev)
    prompts = [torch.from_numpy(np.random.default_rng(s).integers(
        0, lm.vocab_size, size=(batch, plen))).to(dev) for s in range(8)]
    timed_generate(lm, prompts[0], new, kv_quant)  # warm-up
    per_call = sum(timed_generate(lm, prompts[i], new, kv_quant)[1] for i in (1, 2)) / 2
    rate = batch * new / per_call
    n_params = sum(p.numel() for p in lm.parameters())
    avg_len = plen + new / 2
    d, h, L = lm.d_model, lm.n_heads, lm.n_layers
    kv = batch * 2 * L * avg_len * ((d + 4 * h) if kv_quant else 2 * d)
    step_bytes = 2 * n_params + kv
    bw = stream_bw or stream_bytes_per_s(dev, TINY_STREAM_ELEMS if tiny else STREAM_ELEMS)
    frac = step_bytes * (rate / batch) / bw
    log(f"decode{' int8' if kv_quant else ''}: {per_call * 1e3:.1f} ms a {new}-token call "
        f"(batch {batch}) -> {rate:.0f} tokens/s; {step_bytes / 1e6:.0f} MB a step -> "
        f"{100 * frac:.1f}% of the measured {bw / 1e9:.0f} GB/s streaming read")
    return rate, frac, step_bytes, bw


def decode_phase(device, tiny: bool = False) -> dict:
    """Config 8's three decode metrics: tokens/s and the share of the
    measured streaming read with the bf16 cache, tokens/s with the int8
    cache."""
    dev = resolve_device(device)
    hw = hardware(dev)
    rate, frac, step_bytes, bw = bench_decode(dev, tiny)
    q_rate, _, q_bytes, _ = bench_decode(dev, tiny, kv_quant=True, stream_bw=bw)
    batch, plen, new = ((TINY_DECODE_BATCH, TINY_DECODE_PROMPT, TINY_DECODE_NEW) if tiny
                        else (DECODE_BATCH, DECODE_PROMPT, DECODE_NEW))
    cut = f"--tiny: {TINY_LM}; " if tiny else ""
    what = (f"batch {batch}, {plen}-token prompt prefill + {new} generated tokens a call, "
            "greedy, the ring-buffered blocked decode (K8 in every step); host clock around "
            "synchronized calls")
    emit(8, "gpt2_small_decode_throughput", rate, "tokens/sec/chip", hw,
         f"{cut}{what}; {step_bytes / 1e6:.1f} MB a step of mandatory traffic -> "
         f"{100 * frac:.1f}% of the measured streaming read",
         extra={"batch": batch, "prompt": plen, "new_tokens": new})
    emit(8, "gpt2_small_decode_hbm_utilization", 100 * frac,
         "percent of measured HBM roofline", hw,
         f"{cut}mandatory traffic (bf16 parameters + the average live K/V) a step x steps/s, "
         f"against a streaming read measured on this device ({bw / 1e9:.1f} GB/s: a float32 "
         "sum of 256 MB of bf16)", extra={"stream_bytes_per_s": bw, "step_bytes": step_bytes})
    emit(8, "gpt2_small_decode_throughput_int8_kv", q_rate, "tokens/sec/chip", hw,
         f"{cut}the same leg with kv_quant=True (int8 cache + per-key f32 scales, quantized "
         f"at block merges); {q_bytes / 1e6:.1f} MB a step",
         extra={"batch": batch, "prompt": plen, "new_tokens": new})
    return {"gpt2_small_decode_throughput": rate, "gpt2_small_decode_hbm_utilization": frac,
            "gpt2_small_decode_throughput_int8_kv": q_rate}


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


# ------------------------------------------------------------------ configs 4 and 5: ResNet legs

#: (config, metric, model, batch, image size, classes, dtype, steps a
#: dispatch): JAX bench_all.py:207-248, as ``tpu_phase`` runs them
RESNET_LEGS = (
    (4, "resnet18_cifar10_train_throughput", "resnet18", 64, 32, 10, "float32", 20),
    (4, "resnet18_cifar10_train_throughput_bf16", "resnet18", 256, 32, 10, "bfloat16", 10),
    (5, "resnet50_imagenet_shape_train_throughput", "resnet50", 32, 224, 1000, "float32", 4),
    (5, "resnet50_imagenet_shape_train_throughput_bf16", "resnet50", 256, 224, 1000,
     "bfloat16", 2),
)
#: ``--tiny``: every leg at batch 2 and two steps a dispatch, the ImageNet
#: legs at 72 x 72 (still the ImageNet stem) and 10 classes
TINY_RESNET_BATCH, TINY_RESNET_IMAGE, TINY_RESNET_K = 2, 72, 2
RESNET_LR, HOSTFED_LR = 0.008, 0.05
#: the host-fed leg (JAX ``bench_hostfed_resnet50``, bench_all.py:758-816)
HOSTFED_BATCH, HOSTFED_STEPS, HOSTFED_TRIALS = 256, 8, 3


def resnet_macs(name: str, image: int, classes: int) -> int:
    """Conv/linear MACs an image of the ResNet ``name`` at ``image`` x
    ``image``, counted on a float32 copy on the host (the bfloat16 model
    runs its convolutions as functions, which the counting hooks miss)."""
    model = get_model(name, num_classes=classes, device="cpu", input_size=image)
    return sum(conv_linear_macs(model, (1, image, image, 3)).values())


def resnet_scan_step(name: str, batch: int, image: int, classes: int, dtype, k: int,
                     device="cuda"):
    """``dispatch() -> losses [k]``: K SGD steps (lr 0.008) of a
    seed-0 ResNet over k distinct batches of ``make_batch`` at ``image`` x
    ``image``, on ``device`` (a CUDA graph of one step on the card)."""
    dev = resolve_device(device)
    model = get_model(name, num_classes=classes, seed=0, device=dev, dtype=dtype,
                      input_size=image)
    tx = SGD(RESNET_LR)
    state = create_train_state(model, tx)
    scan = make_scan_train_step(model, tx)
    images, labels = make_batch(batch, k=k, shape=(image, image, 3), n_classes=classes)
    x = torch.from_numpy(images).to(dev)
    y = torch.from_numpy(labels).to(dev)
    return lambda: scan(state, x, y)[1]


def bench_hostfed_resnet50(device, batch: int = HOSTFED_BATCH, steps: int = HOSTFED_STEPS,
                           trials: int = HOSTFED_TRIALS, image: int = 224,
                           classes: int = 1000) -> Rate:
    """The overlapped-input leg: ResNet-50 in bf16, each step's batch
    starting in pinned host memory (four distinct bf16 batches from
    ``default_rng(s)``, what a loader ships) and copied ``non_blocking`` on a
    side stream while the previous step runs; the main stream waits on the
    copy's event. Per-step time from ``steps`` and one step (the best of
    ``trials`` each), the host clock around synchronized runs."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    model = get_model("resnet50", num_classes=classes, seed=0, device=dev,
                      dtype=torch.bfloat16, input_size=image)
    tx = SGD(HOSTFED_LR)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx)
    host = []
    for s in range(4):
        x = torch.from_numpy(np.random.default_rng(s).normal(
            size=(batch, image, image, 3)).astype(np.float32)).to(torch.bfloat16)
        host.append(x.pin_memory() if cuda else x)
    labels = torch.from_numpy(np.arange(batch) % classes).to(dev)
    side = torch.cuda.Stream(dev) if cuda else None

    def fetch(i):
        if not cuda:
            return host[i % len(host)].clone(), None
        with torch.cuda.stream(side):
            x = host[i % len(host)].to(dev, non_blocking=True)
            return x, side.record_event()

    def run(n):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        nxt = fetch(0)
        loss = None
        for i in range(n):
            x, ev = nxt
            if cuda:
                torch.cuda.current_stream(dev).wait_event(ev)
                x.record_stream(torch.cuda.current_stream(dev))
            if i + 1 < n:
                nxt = fetch(i + 1)
            _state, loss = step(state, x, labels)
        float(loss)
        return time.perf_counter() - t0

    run(2)  # warm-up: cuDNN's algorithms, the allocator
    short = min(run(1) for _ in range(trials))
    long_ = min(run(steps) for _ in range(trials))
    per_step = (long_ - short) / (steps - 1)
    macs = resnet_macs("resnet50", image, classes)
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    rate = Rate.make(batch / per_step, cnn_train_flops(macs, batch), per_step, name)
    rate.source = "host clock"
    log(f"host-fed resnet50: {per_step * 1e3:.1f} ms/step with the batch copied from pinned "
        f"host memory -> {rate:.0f} img/s ({rate.mfu_note()})")
    return rate


def resnet_phase(device, tiny: bool = False, warmup: int = 2, calls: int = 3) -> dict:
    """Configs 4 and 5's ResNet legs; returns ``{metric: Rate}``. Each scan
    leg trains a fresh seed-0 model K steps a dispatch (``warmup``
    dispatches, then ``calls`` timed by ``utils/devtime.device_time``), its
    FLOPs 6 x the conv/linear MACs an image; then the host-fed leg. Peak
    device memory goes into each record on the card."""
    dev = resolve_device(device)
    hw = hardware(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if tiny:
        calls = 1
    rates = {}
    for config, metric, model_name, leg_batch, leg_image, leg_classes, dt, leg_k in RESNET_LEGS:
        batch, k = (TINY_RESNET_BATCH, TINY_RESNET_K) if tiny else (leg_batch, leg_k)
        image = TINY_RESNET_IMAGE if tiny and leg_image > 64 else leg_image
        classes = 10 if tiny else leg_classes
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        dispatch = resnet_scan_step(model_name, batch, image, classes, dt, k, dev)
        losses = [float(v) for _ in range(warmup) for v in dispatch().cpu()]
        t = device_time(dispatch, calls=calls, warmup=1)
        per_step = t.per_call_s / k
        macs = resnet_macs(model_name, image, classes)
        peak = "bf16" if dt == "bfloat16" else "f32"
        r = Rate.make(batch / per_step, cnn_train_flops(macs, batch), per_step, name,
                      peak=peak)
        r.source = t.source
        rates[metric] = r
        mem = (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None)
        cut = (f"--tiny: batch {batch} at {image}x{image}, {classes} classes, on the leg of "
               f"batch {leg_batch} at {leg_image}x{leg_image}; " if tiny else "")
        emit(config, metric, r, "images/sec/chip", hw,
             f"{cut}{model_name} (GroupNorm), {image}x{image} synthetic, {classes} classes, "
             f"batch {batch}, {dt} activations over float32 parameters, SGD lr {RESNET_LR}, "
             f"{k} steps a dispatch (CUDA graph on the card, a loop on the CPU), "
             f"device-resident input; {per_step * 1e3:.3f} ms/step ({t.source}); FLOPs 6 x "
             f"{macs} conv/linear MACs an image",
             extra={"batch": batch, "image": image, "classes": classes, "dtype": dt,
                    "steps_per_dispatch": k, "warmup_losses": losses, "peak_mem_gb": mem})
        del dispatch
    hb, hi, hc = ((TINY_RESNET_BATCH, TINY_RESNET_IMAGE, 10) if tiny
                  else (HOSTFED_BATCH, 224, 1000))
    r = bench_hostfed_resnet50(dev, batch=hb, image=hi, classes=hc,
                               steps=3 if tiny else HOSTFED_STEPS,
                               trials=1 if tiny else HOSTFED_TRIALS)
    rates["resnet50_hostfed_overlapped_input_throughput"] = r
    cut = f"--tiny: batch {hb} at {hi}x{hi}, {hc} classes; " if tiny else ""
    emit(5, "resnet50_hostfed_overlapped_input_throughput", r, "images/sec/chip", hw,
         f"{cut}batch {hb} bf16, each step's input copied from pinned host memory on a side "
         f"stream while the prior step runs; {r.step_seconds * 1e3:.3f} ms/step (host clock)",
         extra={"batch": hb, "image": hi, "classes": hc})
    return rates


#: north-star metric 2 (JAX ``bench_steps_to_accuracy``, bench_all.py:354-465,
#: emitted at :168-187): the target, the step cap, steps between evals, the
#: eval set and the batch; ``--tiny``: the cap and the eval set
STA_TARGET, STA_MAX_STEPS, STA_EVAL_EVERY, STA_N_EVAL, STA_BATCH = 0.99, 2000, 25, 2000, 64
TINY_STA_MAX_STEPS, TINY_STA_N_EVAL = 50, 256


def bench_steps_to_accuracy(device="cuda", max_steps: int = STA_MAX_STEPS,
                            eval_every: int = STA_EVAL_EVERY, n_eval: int = STA_N_EVAL,
                            init=None) -> dict:
    """Steps to STA_TARGET test accuracy with the reference recipe (unfused
    AlexNet, batch 64, SGD lr 0.008) on the deterministic synthetic set, on
    the JAX function's batch stream: ``default_rng(0)`` indices of shape
    ``(max_steps // eval_every, eval_every, 64)``, ``eval_every`` steps a
    dispatch (``make_scan_train_step``: a CUDA graph on the card), then the
    accuracy on the first ``n_eval`` test images (``make_eval_fn``), stopping
    at the first crossing. ``init`` (a JAX-layout numpy param tree, carried
    by ``utils/interop.params_from_jax``) replaces the port's seeded init.
    Returns ``{"steps": first crossing or None (the cap), "accuracy": the
    last evaluated, "curve": per-eval accuracies, "losses": per-dispatch
    loss arrays}``; a cap hit is a measured outcome."""
    from distributed_ml_pytorch_tpu_torch.data import load_cifar10
    from distributed_ml_pytorch_tpu_torch.training.trainer import make_eval_fn
    from distributed_ml_pytorch_tpu_torch.utils import interop

    dev = resolve_device(device)
    x, y, xt, yt, _ = load_cifar10(synthetic=True)
    xe, ye = xt[:n_eval], yt[:n_eval]
    idx = np.random.default_rng(0).integers(
        0, len(x), size=(max_steps // eval_every, eval_every, STA_BATCH))
    model = get_model("alexnet", seed=0, device=dev)
    if init is not None:
        model.load_state_dict(interop.params_from_jax(init, model))
    tx = SGD(ALEXNET_LR)
    state = create_train_state(model, tx)
    scan = make_scan_train_step(model, tx, eval_every)
    ev = make_eval_fn(model)
    xe_t = torch.from_numpy(xe).to(dev)
    ye_t = torch.from_numpy(ye.astype(np.int64)).to(dev)
    steps, acc, curve, losses = None, 0.0, [], []
    for chunk, sel in enumerate(idx):
        state, chunk_losses = scan(state, x[sel], y[sel])
        losses.append(chunk_losses.cpu().numpy())
        _, preds = ev(xe_t, ye_t)
        acc = float((preds.cpu().numpy() == ye).mean())
        curve.append(acc)
        if acc >= STA_TARGET:
            steps = (chunk + 1) * eval_every
            break
    log(f"steps-to-{STA_TARGET:.0%}: {steps} (final acc {acc:.4f})")
    return {"steps": steps, "accuracy": acc, "curve": curve, "losses": losses}


def steps_to_accuracy_phase(device, tiny: bool = False) -> dict:
    """Emits ``steps_to_99pct_test_accuracy`` (config 1): the steps, or -1
    with the final accuracy and the per-eval curve when the cap was hit."""
    dev = resolve_device(device)
    max_steps = TINY_STA_MAX_STEPS if tiny else STA_MAX_STEPS
    n_eval = TINY_STA_N_EVAL if tiny else STA_N_EVAL
    res = bench_steps_to_accuracy(dev, max_steps=max_steps, n_eval=n_eval)
    cut = f"--tiny: cap {max_steps} steps, {n_eval} eval images; " if tiny else ""
    recipe = (f"reference recipe (unfused AlexNet, batch {STA_BATCH}, SGD lr {ALEXNET_LR}) on "
              f"the deterministic synthetic set, the JAX harness's batch stream, "
              f"{STA_EVAL_EVERY} steps a dispatch, {n_eval} eval images; the port's seeded "
              "He-uniform init")
    curve = ", ".join(f"{a:.4f}" for a in res["curve"])
    capped = res["steps"] is None
    cap = (f"did NOT reach the target within the {max_steps}-step cap (-1 = cap hit); "
           if capped else "")
    emit(1, "steps_to_99pct_test_accuracy", -1 if capped else res["steps"], "steps",
         hardware(dev), f"{cut}{cap}{recipe}; final accuracy {res['accuracy']:.4f}; "
         f"per-eval curve [{curve}]",
         extra={"final_accuracy": res["accuracy"], "curve": res["curve"],
                "eval_every": STA_EVAL_EVERY})
    return res


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
    out["async_ps_chunked_device_cycle"] = ps_device_cycle_phase(dev, tiny=tiny)
    return out


#: the device cycle (JAX ``_ps_device_cycle_phase``, bench_all.py:1649-1717):
#: the DownPour cadence's run lengths at n_push = n_pull = 10, the cycles
#: timed, and ``--tiny``'s batch and cycles
CYCLE_RUNS, CYCLE_REPS, TINY_CYCLE_BATCH, TINY_CYCLE_REPS = (1, 9), 10, 4, 2


def ps_device_cycle_phase(device, tiny: bool = False) -> float:
    """Config 3's device-side ceiling of the DownPour worker: one cadence
    cycle (``n_push = n_pull = 10``: a run of 1 local step, then one of 9,
    ``parallel/async_ps.downpour_chunk_schedule``) as two dispatches of
    ``make_downpour_chunk_step`` (one captured step replayed, K1 inside the
    graph), an unfused seed-0 AlexNet at the card worker's batch 64,
    ``default_downpour_tx(0.008)``, with no host fetch until a trailing loss
    read. Both run lengths warm twice, then ``CYCLE_REPS`` cycles are timed
    on batches already on the device, then on host batches (each dispatch
    copies its own). Emits
    ``10 · batch / per_cycle``; returns it. The record carries K1's launches
    (the wrappers count the warm-up steps and the capture, not replays) and
    the captures."""
    from distributed_ml_pytorch_tpu_torch.ops import fused_update
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import make_downpour_chunk_step

    dev = resolve_device(device)
    batch, reps = (TINY_CYCLE_BATCH, TINY_CYCLE_REPS) if tiny else (PS_CARD_BATCH, CYCLE_REPS)
    model = get_model("alexnet", seed=0, device=dev)
    tx = default_downpour_tx(ALEXNET_LR)
    opt_state = tx.init(list(model.parameters()))
    _flat, n, _pad, accum = init_downpour_accumulator(model)
    fused_update.launches = 0
    chunk = make_downpour_chunk_step(model, tx, accum, n, capacity=max(CYCLE_RUNS))
    rnd = np.random.default_rng(0)
    host = [(rnd.normal(size=(length, batch, 32, 32, 3)).astype(np.float32),
             rnd.integers(0, 10, (length, batch))) for length in CYCLE_RUNS]
    resident = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)) for x, y in host]
    losses = None
    for _ in range(2):  # both run lengths: warm-up steps, the capture, replays
        for x, y in resident:
            losses = chunk(opt_state, x, y)
    float(losses[-1])

    def cycle_s(batches) -> float:
        nonlocal losses
        t0 = time.perf_counter()
        for _ in range(reps):
            for x, y in batches:
                losses = chunk(opt_state, x, y)
        float(losses[-1])  # the one host fetch: it waits for the whole chain
        return (time.perf_counter() - t0) / reps

    per_cycle = cycle_s(resident)
    with_copy = cycle_s(host)
    steps = sum(CYCLE_RUNS)
    rate = steps * batch / per_cycle
    cut = f"--tiny: batch {batch}, {reps} cycles; " if tiny else ""
    emit(3, "async_ps_chunked_device_cycle", rate, "images/sec/chip",
         f"{hardware(dev)}, device-resident input",
         f"{cut}one {steps}-step DownPour cadence cycle (runs of {CYCLE_RUNS[0]} and "
         f"{CYCLE_RUNS[1]} local steps) as two chunked dispatches of one captured step "
         f"(a loop on the CPU), unfused AlexNet at batch {batch}, forced completion by one "
         f"trailing loss read ({per_cycle * 1e3:.3f} ms/cycle, host clock, {reps} cycles); "
         f"with host batches copied by each dispatch {steps * batch / with_copy:.1f} img/s "
         f"({with_copy * 1e3:.3f} ms/cycle)",
         extra={"batch": batch, "ms_per_cycle": per_cycle * 1e3,
                "host_fed_images_per_s": steps * batch / with_copy,
                "host_fed_ms_per_cycle": with_copy * 1e3,
                "k1_launches": fused_update.launches,
                "captures": chunk.graphed.captures})
    return rate


#: the sharded leg's recipe (JAX bench_all.py:1017-1019): images a worker
#: and batch, the worlds' shard counts, the apply microbench's repetitions
SHARDED_PER_WORKER, SHARDED_BATCH, SHARDED_KS, SHARDED_APPLY_REPS = 384, 16, (1, 2, 4), 50
#: ``--tiny``: images a worker
TINY_SHARDED_PER_WORKER = 32

_SHARD_RTT_SERVER_SRC = """
import sys
import numpy as np
from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import make_shard_server
from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport

shard, k, n, port = (int(a) for a in sys.argv[1:5])
t = make_transport(0, 2, port=port, kind="python", connect_timeout=120)
try:
    make_shard_server(params=np.zeros(n, np.float32), shard=shard, n_shards=k,
                      transport=t, n_workers=1).run(timeout=600)
finally:
    t.close()
"""


def _child_env() -> dict:
    """A child process's environment: this checkout importable."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def bench_sharded_push_rtt(k: int, flat: np.ndarray, rounds: int = 20,
                           warmup: int = 3) -> float:
    """Mean seconds of one round against ``k`` shard server processes over
    TCP: every shard is pushed its slice of a full gradient, then asked for
    its slice, and the round ends when all ``k`` replies have arrived. A
    server process that fails raises."""
    from distributed_ml_pytorch_tpu_torch.launch import _free_port
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import Listener
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import shard_ranges
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        MessageCode,
        make_transport,
        send_message,
    )

    n = flat.shape[0]
    ranges = shard_ranges(n, k)
    ports = [_free_port() for _ in range(k)]
    procs = [subprocess.Popen([sys.executable, "-c", _SHARD_RTT_SERVER_SRC, str(s), str(k),
                               str(n), ports[s]], env=_child_env())
             for s in range(k)]
    transports, listeners, times = [], [], []
    grad = np.full(n, -1e-3, np.float32)
    empty = np.zeros(0, np.float32)
    try:
        transports = [make_transport(1, 2, port=int(p), kind="python", connect_timeout=120)
                      for p in ports]
        listeners = [Listener(transport=t) for t in transports]
        for listener in listeners:
            listener.start()
        for s, (lo, hi) in enumerate(ranges):
            send_message(MessageCode.ParameterUpdate, flat[lo:hi], transport=transports[s])
        for r in range(warmup + rounds):
            t0 = time.perf_counter()
            for s, (lo, hi) in enumerate(ranges):
                send_message(MessageCode.GradientUpdate, grad[lo:hi], transport=transports[s])
            for t in transports:
                send_message(MessageCode.ParameterRequest, empty, transport=t)
            deadline = t0 + 120.0
            for s, listener in enumerate(listeners):
                while listener.take_latest() is None:
                    if time.perf_counter() > deadline:
                        raise TimeoutError(f"shard {s}'s reply never arrived")
                    time.sleep(0.0005)
            if r >= warmup:
                times.append(time.perf_counter() - t0)
        for t in transports:
            send_message(MessageCode.WorkerDone, empty, transport=t)
    finally:
        for listener in listeners:
            listener.stop()
        for t in transports:
            t.close()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"a shard server of the k={k} round-trip bench failed")
    rtt = float(np.mean(times))
    log(f"sharded push round trip, k={k}: {rtt * 1e3:.3f} ms mean over {rounds} rounds "
        f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f})")
    return rtt


def sharded_ps_phase(device, tiny: bool = False) -> dict:
    """Config 3's sharded leg; returns ``{metric: value}``. Any failed
    world or server process fails the leg (raises)."""
    from distributed_ml_pytorch_tpu_torch.launch import launch_world
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import shard_ranges
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

    dev = resolve_device(device)
    hw = hardware(dev)
    cut = "--tiny: fewer images; " if tiny else ""
    flat = ravel_model_params(get_model("alexnet", seed=0, device="cpu")).numpy()
    n = flat.shape[0]
    out = {}
    for k in SHARDED_KS:
        lo, hi = shard_ranges(n, k)[0]
        server = ParameterServer(params=flat[lo:hi])
        payload = np.random.default_rng(0).normal(size=hi - lo).astype(np.float32)
        t0 = time.perf_counter()
        for _ in range(SHARDED_APPLY_REPS):
            server.handle(1, MessageCode.GradientUpdate, payload)
        us = (time.perf_counter() - t0) / SHARDED_APPLY_REPS * 1e6
        out[f"sharded_ps_per_shard_apply_k{k}"] = us
        emit(3, f"sharded_ps_per_shard_apply_k{k}", us, "microseconds/push", "1 cpu core",
             f"the server's apply of one push on the {hi - lo:,}-element slice "
             f"({(hi - lo) * 4 / 1e6:.1f} MB), host clock, mean of {SHARDED_APPLY_REPS}")
    for k in (1, 2):
        rtt = bench_sharded_push_rtt(k, flat)
        out[f"sharded_ps_e2e_push_rtt_k{k}"] = rtt * 1e3
        emit(3, f"sharded_ps_e2e_push_rtt_k{k}", rtt * 1e3, "milliseconds/roundtrip",
             f"{k + 1} cpu processes, TCP",
             f"mean push+pull round trip of the full {n * 4 / 1e6:.1f} MB gradient against "
             f"{k} shard server process(es), Python transport, host clock")
    per_worker = TINY_SHARDED_PER_WORKER if tiny else SHARDED_PER_WORKER
    for k in SHARDED_KS:
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            code = launch_world(k + 2, [
                "--backend", dev.type, "--epochs", "1", "--synthetic-data",
                "--synthetic-train-size", str(per_worker), "--synthetic-test-size", "64",
                "--test-batch-size", "64", "--batch-size", str(SHARDED_BATCH),
                "--log-interval", "100000", "--log-dir", td], n_servers=k)
            dt = time.perf_counter() - t0
        if code != 0:
            raise RuntimeError(f"the sharded world at k={k} exited with code {code}")
        agg = 2 * per_worker / dt
        out[f"sharded_ps_k{k}_aggregate_throughput"] = agg
        emit(3, f"sharded_ps_k{k}_aggregate_throughput", agg, "images/sec",
             f"{hw}, {k + 2} processes",
             f"{cut}2 AlexNet workers x {per_worker} images at batch {SHARDED_BATCH} "
             f"against {k} shard server(s) in {dt:.1f}s wall, start-up included; TCP, "
             "transport auto, n_push = n_pull = 10, one step a dispatch")
    return out


#: the transport leg's echoes, after 2 of warm-up (JAX bench_all.py:1730)
TRANSPORT_ROUNDS = 30

_ECHO_SERVER_SRC = """
import sys
from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport

t = make_transport(0, 2, port=int(sys.argv[1]), kind=sys.argv[2], connect_timeout=120)
for _ in range(int(sys.argv[3])):
    sender, code, payload = t.recv(timeout=120)
    t.send(code, payload, dst=sender)
t.close()
"""


def transport_phase(device=None, tiny: bool = False) -> dict:
    """Config 7's wire leg; returns ``{metric: round trips/s}``. A failed
    echo raises."""
    from distributed_ml_pytorch_tpu_torch.launch import _free_port
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode, make_transport

    payload = np.zeros(2_472_266, np.float32)  # AlexNet's flat vector
    out = {}
    for kind in ("native", "python"):
        port = _free_port()
        srv = subprocess.Popen([sys.executable, "-c", _ECHO_SERVER_SRC, port, kind,
                                str(TRANSPORT_ROUNDS + 2)], env=_child_env())
        t = None
        try:
            t = make_transport(1, 2, port=int(port), kind=kind, connect_timeout=120)
            for _ in range(2):  # warm both directions
                t.send(MessageCode.GradientUpdate, payload)
                if t.recv(timeout=120) is None:
                    raise TimeoutError(f"the {kind} echo did not answer")
            t0 = time.perf_counter()
            for _ in range(TRANSPORT_ROUNDS):
                t.send(MessageCode.GradientUpdate, payload)
                if t.recv(timeout=120) is None:
                    raise TimeoutError(f"the {kind} echo did not answer")
            rate = TRANSPORT_ROUNDS / (time.perf_counter() - t0)
        finally:
            if t is not None:
                t.close()
            try:
                srv.wait(timeout=60)
            except subprocess.TimeoutExpired:
                srv.kill()
                srv.wait()
        if srv.returncode != 0:
            raise RuntimeError(f"the {kind} echo process exited with code {srv.returncode}")
        out[f"ps_transport_roundtrip_{kind}"] = rate
        emit(7, f"ps_transport_roundtrip_{kind}", rate, "roundtrips/sec",
             "2 processes, localhost TCP",
             f"9.9 MB payload echo ({2 * payload.nbytes * rate / 1e6:.0f} MB/s both ways), "
             f"{TRANSPORT_ROUNDS} round trips after 2 of warm-up, host clock")
    return out


#: the reliability leg (JAX ``reliability_phase``, bench_all.py:1773-1885):
#: round trips a round, rounds, and ``--tiny``'s
RELIABILITY_ITERS, RELIABILITY_ROUNDS, TINY_RELIABILITY_ITERS = 20, 4, 4
RELIABILITY_MODES = {
    "off": "no reliability layer",
    "legacy": "the older envelope: the frame concatenated into one copy, a tobytes copy "
              "and a whole-body crc32, one ack per frame (legacy_envelope=True, "
              "batched_acks=False)",
    "on": "the current wire: zero-copy checksums, scatter/gather envelope, batched "
          "cumulative acks",
}

_RELIABLE_ECHO_SRC = """
import sys
from distributed_ml_pytorch_tpu_torch.utils.messaging import ReliableTransport, make_transport

port, mode, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
t = make_transport(0, 2, port=int(port), kind="python", connect_timeout=120)
if mode != "off":
    t = ReliableTransport(t, ack_timeout=5.0, max_backoff=10.0, batched_acks=mode == "on",
                          legacy_envelope=mode == "legacy")
for _ in range(n):
    sender, code, payload = t.recv(timeout=120)
    t.send(code, payload, dst=sender)
t.close()
"""


def reliability_phase(device=None, tiny: bool = False) -> dict:
    """Config 7's reliability leg: the Python-TCP echo of AlexNet's
    2,472,266-float vector with the reliable layer off, on the older
    envelope (``legacy``) and on the current one (``on``), each against an
    echo process of its own, ``ack_timeout=5.0``, ``max_backoff=10.0``; the
    modes interleaved over ``RELIABILITY_ROUNDS`` rounds, each round's rate
    one over its median round trip, each mode keeping its best round.
    Emits the three rates, the current layer's overhead and the share of the
    older envelope's overhead it recovers. A failed echo raises."""
    from distributed_ml_pytorch_tpu_torch.launch import _free_port
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        MessageCode,
        ReliableTransport,
        make_transport,
    )

    payload = np.zeros(2_472_266, np.float32)
    n_iter = TINY_RELIABILITY_ITERS if tiny else RELIABILITY_ITERS
    rounds = 1 if tiny else RELIABILITY_ROUNDS
    rates = {}
    for _ in range(rounds):
        for mode in RELIABILITY_MODES:
            port = _free_port()
            srv = subprocess.Popen([sys.executable, "-c", _RELIABLE_ECHO_SRC, port, mode,
                                    str(n_iter + 2)], env=_child_env())
            t = None
            try:
                t = make_transport(1, 2, port=int(port), kind="python", connect_timeout=120)
                if mode != "off":
                    t = ReliableTransport(t, ack_timeout=5.0, max_backoff=10.0,
                                          batched_acks=mode == "on",
                                          legacy_envelope=mode == "legacy")
                times = []
                for i in range(n_iter + 2):  # the first two warm both directions
                    t0 = time.perf_counter()
                    t.send(MessageCode.GradientUpdate, payload)
                    if t.recv(timeout=120) is None:
                        raise TimeoutError(f"the echo with acks {mode} did not answer")
                    if i >= 2:
                        times.append(time.perf_counter() - t0)
                rates[mode] = max(rates.get(mode, 0.0), 1.0 / float(np.median(times)))
            finally:
                if t is not None:
                    t.close()
                try:
                    srv.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    srv.kill()
                    srv.wait()
            if srv.returncode != 0:
                raise RuntimeError(f"the echo with acks {mode} exited with code "
                                   f"{srv.returncode}")
    cut = f"--tiny: {rounds} round of {n_iter}; " if tiny else ""
    out = {}
    for mode, desc in RELIABILITY_MODES.items():
        metric = f"ps_transport_roundtrip_python_acks_{mode}"
        out[metric] = rates[mode]
        emit(7, metric, rates[mode], "roundtrips/sec", "2 processes, localhost TCP",
             f"{cut}9.9 MB gradient payload echo ({2 * payload.nbytes * rates[mode] / 1e6:.0f} "
             f"MB/s both ways), median round trip, best of {rounds} rounds, {desc} "
             "(utils/messaging.ReliableTransport), host clock")
    overhead = 100 * (1 - rates["on"] / rates["off"])
    before = 100 * (1 - rates["legacy"] / rates["off"])
    out["ps_reliability_layer_overhead"] = overhead
    emit(7, "ps_reliability_layer_overhead", overhead, "percent", "derived",
         f"{cut}round-trip-rate cost of acks, checksums and dedup on the 9.9 MB echo "
         "(positive = the reliable layer slower)")
    recovered = 100 * (before - overhead) / max(1e-9, before)
    out["ps_reliability_ack_tax_recovered"] = recovered
    emit(7, "ps_reliability_ack_tax_recovered", recovered, "percent of legacy overhead",
         "derived", f"{cut}the older envelope costs {before:.1f}% of the plain round trips/s "
         f"in this run, the current wire {overhead:.1f}%")
    return out


#: the wire_bytes leg's vector (AlexNet's, the 9.9 MB dense push), its
#: timed pushes, and ``--tiny``'s
WIRE_N, WIRE_ITERS = 2_472_266, 12
TINY_WIRE_N, TINY_WIRE_ITERS = 65_536, 3


def wire_bytes_phase(device=None, tiny: bool = False) -> dict:
    """Config 7's compressed-wire ladder (the module docstring's
    ``wire_bytes``); returns ``{metric: value}``. Bytes are exact frame
    arithmetic; rates are host wall clock."""
    import threading

    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import Listener
    from distributed_ml_pytorch_tpu_torch.utils import codecs
    from distributed_ml_pytorch_tpu_torch.utils.compress import (
        CODEC_DENSE,
        CODEC_INT8,
        CompressingEncoder,
        make_codec,
    )
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        InProcessTransport,
        MessageCode,
        make_world,
    )

    n, n_iter = (TINY_WIRE_N, TINY_WIRE_ITERS) if tiny else (WIRE_N, WIRE_ITERS)
    cut = f"--tiny: {n} floats, {n_iter} pushes; " if tiny else ""
    rng = np.random.default_rng(0)
    out, bytes_per_push = {}, {}

    def record(metric, value, unit, hw, note):
        out[metric] = value
        emit(7, metric, value, unit, hw, cut + note)

    for mode in ("dense", "int8", "topk"):
        world, _ = make_world(2, reliable=True,
                              reliable_opts={"ack_timeout": 5.0, "max_backoff": 10.0})
        ps = ParameterServer(params=np.zeros(n, np.float32), transport=world[0])
        stop = threading.Event()

        def serve():
            while not stop.is_set():
                msg = world[0].recv(timeout=0.2)
                if msg is not None:
                    ps.handle(*msg)

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        try:
            enc = (None if mode == "dense"
                   else CompressingEncoder(n, make_codec(mode, block=1024, k_frac=0.01)))
            vec = rng.normal(scale=0.01, size=n).astype(np.float32)

            def push():
                if enc is None:
                    world[1].send(MessageCode.GradientUpdate, vec, dst=0)
                    return n * 4
                head, body = enc.encode_range(vec, 0, n)
                world[1].sendv(MessageCode.CompressedUpdate, (head, body), dst=0)
                return int((head.size + body.size) * 4)

            push()  # warm both directions and the server's first decode
            world[1].flush(timeout=60)
            t0 = time.perf_counter()
            for _ in range(n_iter):
                nbytes = push()
                # flushed each push: the rate includes the ack's round trip
                world[1].flush(timeout=60)
            rate = n_iter / (time.perf_counter() - t0)
        finally:
            stop.set()
            t.join(timeout=10)
            for tr in world.values():
                tr.close()
        if ps._apply_seq != n_iter + 1:
            raise RuntimeError(f"the {mode} rung applied {ps._apply_seq} of {n_iter + 1} pushes")
        bytes_per_push[mode] = nbytes
        record(f"ps_wire_bytes_per_push_{mode}", nbytes, "bytes",
               "in-process, reliable envelope",
               f"exact frame bytes of one {mode} push of the {n}-param vector (envelope "
               "header excluded: +36 B either way); decoded server-side inside the loop")
        record(f"ps_push_roundtrips_{mode}", rate, "pushes/sec",
               "in-process, reliable envelope",
               f"acked {mode} pushes/s incl. encode + decode + apply "
               f"({nbytes * rate / 1e6:.1f} MB/s on-wire), host clock; dense TCP echo "
               "baseline: reliability leg")
    for mode in ("int8", "topk"):
        record(f"ps_wire_compression_ratio_{mode}",
               bytes_per_push["dense"] / bytes_per_push[mode], "x fewer bytes", "derived",
               f"dense / {mode} bytes-on-wire per push (error-feedback encoder, "
               "utils/compress.py)")

    def codec_ladder(tag, code, x, head_floats, note, iters=20):
        sizes = {}
        for mode, cid in (("dense", CODEC_DENSE), ("int8", CODEC_INT8)):
            t0 = time.perf_counter()
            for _ in range(iters):
                got, body = codecs.encode_body(code, x, cid)
                codecs.decode_body(code, got, body, x.size)
            dt = time.perf_counter() - t0
            nbytes = int((head_floats + body.size) * 4)
            sizes[mode] = nbytes
            record(f"{tag}_wire_bytes_per_frame_{mode}", nbytes, "bytes",
                   "registry encode_body/decode_body",
                   f"exact frame bytes ({head_floats}-float head + body) of one {mode} "
                   f"{code.name} frame of {x.size} floats; {note}")
            record(f"{tag}_codec_frames_per_s_{mode}", iters / dt, "frames/sec",
                   "registry encode_body/decode_body",
                   f"{mode} encode + decode round trips/s on one core "
                   f"({iters / dt * nbytes / 1e6:.1f} MB/s on-wire), host clock")
        return sizes

    act = rng.normal(scale=2.0, size=8 * 128 * 256).astype(np.float32)
    sizes = codec_ladder("act", MessageCode.ActivationShip, act, 8,
                         "the pipeline's activation hand-off (one microbatch of 8 x 128 x 256)")
    record("act_wire_compression_ratio_int8", sizes["dense"] / sizes["int8"], "x fewer bytes",
           "derived", "dense / int8 bytes per activation frame")
    kv = rng.normal(scale=0.5, size=1024 * 128).astype(np.float32)
    sizes = codec_ladder("kv_migrate", MessageCode.KvMigrate, kv, 9,
                         "the token lane of the same frame rides tok16 (exact)")
    record("kv_migrate_compression_ratio_int8", sizes["dense"] / sizes["int8"],
           "x fewer bytes", "derived", "dense / int8 bytes per migrated KV lane")

    # delta pull replies through the server's real reply path
    world = InProcessTransport.create_world(2)
    try:
        ps = ParameterServer(params=rng.normal(scale=0.01, size=n).astype(np.float32),
                             transport=world[0])
        lst = Listener(transport=world[1])

        def delta_pull():
            before = ps.delta_reply_wire_floats
            ps.handle(1, MessageCode.ParameterRequest, lst.held_stamp())
            msg = world[1].recv(timeout=5.0)
            if msg is None:
                raise TimeoutError("no delta reply")
            lst.receive(*msg)
            return (ps.delta_reply_wire_floats - before) * 4

        full_bytes = delta_pull()  # the first pull: a full install
        upd = rng.normal(scale=1e-4, size=n).astype(np.float32)
        n_pulls, delta_bytes, spent = 6, 0, 0.0
        for _ in range(n_pulls):
            ps.handle(1, MessageCode.GradientUpdate, upd)
            t0 = time.perf_counter()
            delta_bytes = delta_pull()
            spent += time.perf_counter() - t0
    finally:
        for tr in world.values():
            tr.close()
    if (lst.full_installs, lst.delta_installs, lst.delta_base_miss) != (1, n_pulls, 0):
        raise RuntimeError(f"delta ladder installs: full {lst.full_installs}, delta "
                           f"{lst.delta_installs}, base misses {lst.delta_base_miss}")
    hw = "in-process, real delta-reply path"
    record("pull_reply_bytes_full", full_bytes, "bytes", hw,
           f"exact wire bytes of the full dense install of the {n}-param vector")
    record("pull_reply_bytes_delta_steady", delta_bytes, "bytes", hw,
           "exact wire bytes of one steady top-k delta reply (the server tracks the "
           "worker's installed view)")
    record("pull_reply_roundtrips_delta", n_pulls / spent, "pulls/sec", hw,
           f"steady delta pulls/s incl. encode + decode + install "
           f"({delta_bytes * n_pulls / spent / 1e6:.1f} MB/s on-wire), host clock")
    record("pull_reply_compression_ratio_delta", full_bytes / max(delta_bytes, 1),
           "x fewer bytes", "derived", "full / steady delta reply bytes")
    return out


#: the elastic leg (JAX ``elastic_phase``, bench_all.py:1045-1102): steps of
#: each worker, the step of worker 1 at which shard 2 crashes, the lease, the
#: batch; and ``--tiny``'s steps and crash step
ELASTIC_STEPS, ELASTIC_CRASH_AT, ELASTIC_LEASE, ELASTIC_BATCH = 72, 24, 0.4, 16
TINY_ELASTIC_STEPS, TINY_ELASTIC_CRASH_AT = 36, 12


def elastic_phase(device, tiny: bool = False) -> dict:
    """Config 3's elastic leg: worker 1's throughput before, during and after
    a coordinator-driven rebalance, in images/s a worker. One in-process
    fleet (``coord/demo.elastic_scenario``: a coordinator, two elastic shard
    servers, two DownPour workers of LeNet on ``device``, batch 16, cadence
    2/2, lease 0.4 s); shard server 2 crashes silently at worker 1's step
    24, the coordinator finds it by lease expiry, and the workers drain,
    cut over and install the moved range. The windows split worker 1's
    step times at the crash and at its first step on the new map: steps
    4-24, 24 to the cutover (the lease running out, stale-map drops, the
    drain) and the rest, with the fleet one server smaller. Returns
    ``{metric: images/s}``; an incomplete run raises."""
    from distributed_ml_pytorch_tpu_torch.coord.demo import elastic_scenario

    steps, crash_at = ((TINY_ELASTIC_STEPS, TINY_ELASTIC_CRASH_AT) if tiny
                       else (ELASTIC_STEPS, ELASTIC_CRASH_AT))
    times: dict = {}
    cut: dict = {}

    def hook(j, step, opt):
        if j == 1:
            times[step] = time.perf_counter()
            if opt.map_version >= 3 and "step" not in cut:
                cut["step"] = step  # the first step on the post-crash map

    out = elastic_scenario(steps=steps, n_workers=2, n_shards=2, crash_shard_at=crash_at,
                           lease=ELASTIC_LEASE, batch=ELASTIC_BATCH, model="lenet",
                           device=device, step_hook=hook)
    if not out["ok"] or "step" not in cut:
        raise RuntimeError(f"elastic_phase incomplete: ok={out['ok']} cutover={cut} "
                           f"errors={out['errors']} events={out['events'][-5:]}")

    def rate(a, b):
        ts = [times[s] for s in range(a, b) if s in times]
        if len(ts) < 3:
            raise RuntimeError(f"elastic_phase: window [{a}, {b}) too short to rate")
        return ELASTIC_BATCH * (len(ts) - 1) / (ts[-1] - ts[0])

    res = {}
    cut_at = cut["step"]
    tiny_note = f"--tiny: {steps} steps, crash at {crash_at}; " if tiny else ""
    hw = "in-process fleet, " + ("the card" if torch.device(device).type == "cuda" else "CPU")
    for name, a, b, win in (
            ("before", 4, crash_at, f"steps 4-{crash_at}"),
            ("during", crash_at, cut_at + 1,
             f"steps {crash_at}-{cut_at} (crash -> lease expiry -> map adopted)"),
            ("after", cut_at + 1, steps, f"steps {cut_at + 1}-{steps}, 1 shard left")):
        metric = f"elastic_rebalance_throughput_{name}"
        res[metric] = rate(a, b)
        emit(3, metric, res[metric], "images/sec/worker", hw,
             f"{tiny_note}worker-1 steady state {win}; coordinator lease {ELASTIC_LEASE}s; LeNet "
             f"batch {ELASTIC_BATCH}, cadence 2/2 (coord/demo.elastic_scenario)")
    log(f"elastic_phase: map v{out['map_version']}, cutover at worker step {cut_at}, "
        f"server stats {out['stats']}")
    return res


def _fleet_hw(device) -> str:
    return "in-process fleet, " + ("the card" if torch.device(device).type == "cuda" else "CPU")


def recovery_phase(device) -> dict:
    """Config 3's durability leg: the recovery drill (snapshot barrier, both
    shards killed silently, restore from manifest and WALs) priced as MTTR
    and restore time, with the acked <= applied accounting in the note."""
    import tempfile

    from distributed_ml_pytorch_tpu_torch.coord.drill import default_drill_plan, recovery_drill

    with tempfile.TemporaryDirectory(prefix="bench_drill_") as d:
        out = recovery_drill(base_dir=d, seed=0, plan=default_drill_plan(0), device=device)
    if not out["ok"] or out["mttr_s"] is None:
        raise RuntimeError(f"recovery_phase incomplete: ok={out['ok']} errors={out['errors']} "
                           f"events={out['events'][-5:]}")
    acked = sum(sum(v.values()) for v in out["acked"].values())
    applied = sum(sum(v.values()) for v in out["applied"].values())
    hw = _fleet_hw(device)
    res = {"recovery_mttr": out["mttr_s"] * 1e3, "recovery_restore": out["restore_s"] * 1e3}
    emit(3, "recovery_mttr", res["recovery_mttr"], "ms", hw,
         "kill ALL shards mid-epoch -> manifest+WAL restore -> every shard serving pulls "
         f"again; {out['replayed_updates']} WAL update(s) replayed; acked={acked} <= "
         f"applied={applied} (zero acked loss); 2 workers + 2 shards, LeNet, "
         "coord/drill.recovery_drill")
    emit(3, "recovery_restore", res["recovery_restore"], "ms", hw,
         "manifest load + checkpoint restore + WAL replay + dedup reseed for both shards "
         "(the MTTR component the durability plane owns)")
    log(f"recovery_phase: replayed {out['replayed_updates']}, chaos {out['chaos_counts']}")
    return res


def coordfail_phase(device) -> dict:
    """Config 3's control-plane durability leg: the coordinator killed
    mid-barrier and restarted over its durable directory, priced as MTTR
    and restore time, with the worker steps lost in the note."""
    import tempfile

    from distributed_ml_pytorch_tpu_torch.coord.drill import coordfail_drill

    steps, n_workers, batch = 20, 2, 16
    with tempfile.TemporaryDirectory(prefix="bench_coordfail_") as d:
        out = coordfail_drill(base_dir=d, seed=0, steps=steps, kill_during="snapshot",
                              batch=batch, device=device)
    if not out["ok"] or out["mttr_s"] is None:
        raise RuntimeError(f"coordfail_phase incomplete: ok={out['ok']} errors={out['errors']} "
                           f"violations={out['violations']} events={out['events2'][-5:]}")
    lost = steps * n_workers - sum(len(v) for v in out["losses"].values())
    hw = _fleet_hw(device)
    res = {"coordfail_mttr": out["mttr_s"] * 1e3, "coordfail_restore": out["restore_s"] * 1e3}
    emit(3, "coordfail_mttr", res["coordfail_mttr"], "ms", hw,
         "kill the coordinator mid-snapshot-barrier -> restart from its ckpt+WAL (epoch "
         f"{out['epochs'][0]} -> {out['epochs'][1]}) -> every member re-attached; "
         f"{out['restored_members']} member(s) restored, {len(out['evictions'])} evicted "
         f"during the grace window; {lost} of {steps * n_workers} worker steps "
         f"({lost * batch} samples) lost to the outage (fail-open); 2 workers + 2 shards, "
         "LeNet, coord/drill.coordfail_drill")
    emit(3, "coordfail_restore", res["coordfail_restore"], "ms", hw,
         "persisted-epoch bump + checkpoint load + control-plane WAL replay (member table, "
         "map/snapshot clocks) — the MTTR component the durable coordinator owns")
    log(f"coordfail_phase: outage {out['outage_s'] * 1e3:.0f} ms, chaos {out['chaos_counts']}")
    return res


def health_phase(device) -> dict:
    """Config 3's numerical-health leg: the poisoned-worker scenario priced
    as the quarantine reject rate, the nacks the workers heard and the
    watchdog's rollback MTTR."""
    import tempfile

    from distributed_ml_pytorch_tpu_torch.coord.health import health_scenario

    with tempfile.TemporaryDirectory(prefix="bench_health_") as d:
        out = health_scenario(base_dir=d, seed=0, device=device)
    if not out["ok"] or out["rollbacks"] < 1 or out["rollback_mttr_s"] is None:
        raise RuntimeError(f"health_phase incomplete: ok={out['ok']} rollbacks="
                           f"{out['rollbacks']} errors={out['errors']} "
                           f"events={out['events'][-5:]}")
    applied = sum(sum(v.values()) for v in out["applied"].values())
    seen = applied + out["quarantined_total"]
    hw = _fleet_hw(device)
    res = {"health_reject_rate": 100.0 * out["quarantined_total"] / seen if seen else 0.0,
           "health_nack_roundtrips": float(sum(out["worker_nacks"].values())),
           "health_rollback_mttr": out["rollback_mttr_s"] * 1e3}
    emit(3, "health_reject_rate", res["health_reject_rate"], "%", hw,
         f"admission gate: {out['quarantined_total']} of {seen} arriving updates quarantined "
         f"(finiteness + per-worker EWMA z-score), every one explicitly nacked "
         f"({out['nacks_sent_total']} UpdateNacks), zero in any WAL; 2 workers + 2 shards, one "
         "poisoned push channel, coord/health.health_scenario")
    emit(3, "health_nack_roundtrips", res["health_nack_roundtrips"], "nacks", hw,
         "UpdateNacks that completed the round trip (server reject -> worker heard it, "
         f"resynced by pulling fresh params and held its update); {out['revoked_workers']} "
         "worker(s) reputation-revoked by the coordinator")
    emit(3, "health_rollback_mttr", res["health_rollback_mttr"], "ms", hw,
         "coordinator watchdog detects fleet loss divergence -> RollbackRequest barrier -> "
         "both shards restore the last good FleetManifest (ckpt + WAL capped at its apply "
         "seq) -> all RollbackDone reports in; workers drop accumulators and pull")
    log(f"health_phase: revoked {out['revoked_workers']}, chaos {out['chaos_counts']}")
    return res


def _serving_slot_rate(device) -> tuple:
    """``(tokens/s, p50 TTFT ms)`` of one engine slot: a real
    ``ServingEngine`` burst of 8 requests of 24 tokens, after one warm-up
    request outside the timed window. The rate the ``sched`` leg prices a
    borrowed slot's serving with."""
    from distributed_ml_pytorch_tpu_torch.serving.engine import ServingEngine

    lm = TransformerLM(**TINY_LM, max_len=256, seed=0, device=device)
    engine = ServingEngine(lm, slots=4, cache_size=128)
    warm = engine.submit(np.zeros(16, np.int32), 10)
    engine.run_until_idle()
    if not warm.done:
        raise RuntimeError("the serving warm-up request did not finish")
    engine.reset_metrics()
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    handles = [engine.submit(rng.integers(0, 128, size=16).astype(np.int32), 24)
               for _ in range(8)]
    engine.run_until_idle()
    burst = time.perf_counter() - t0
    tokens = sum(len(h.tokens) for h in handles)
    ttft = engine.slo_summary().get("ttft_ms") or {}
    return tokens / max(burst, 1e-9), ttft.get("p50")


def sched_goodput(out: dict, serve_rate: float, ttft_p50) -> tuple:
    """``(uplift, extra)`` of one ``sched_drill`` day: the shared fleet's
    useful slot-seconds over two static half-fleets', and the record's
    breakdown. Shared: both slots train off-peak, one is lent for the peak
    window, the transitions cost the measured MTTRs. Static: one slot trains
    all day, one serves all day with live demand only in the peak window;
    its training steps are extrapolated linearly in slot-seconds from the
    measured day."""
    s = out["sched"]
    preempt_mttr, resume_mttr = s["preempt_mttr_s"][0], s["resume_mttr_s"][0]
    wall = out["wall_s"]
    peak = out["peak_window_s"] or 0.0
    in_corridor = all(np.mean(v[-4:]) < np.mean(v[:4]) for v in out["losses"].values())
    train_steps = sum(len(v) for v in out["losses"].values())
    shared_train_slot_s = 2 * wall - peak
    shared_serve_s = max(0.0, peak - preempt_mttr)
    static_train_slot_s = wall
    static_serve_s = peak
    static_train_steps = train_steps * static_train_slot_s / max(shared_train_slot_s, 1e-9)
    shared_useful = shared_train_slot_s + shared_serve_s - resume_mttr
    static_useful = static_train_slot_s + static_serve_s
    extra = {
        "day_s": round(wall, 2),
        "peak_window_s": round(peak, 2),
        "shared": {"train_steps": train_steps, "train_in_loss_corridor": bool(in_corridor),
                   "serve_tokens_in_slo": int(serve_rate * shared_serve_s),
                   "useful_slot_s": round(shared_useful, 2)},
        "static": {"train_steps_extrapolated": int(static_train_steps),
                   "serve_tokens_in_slo": int(serve_rate * static_serve_s),
                   "useful_slot_s": round(static_useful, 2)},
        "serve_tokens_per_s": round(serve_rate, 1),
        "serve_ttft_p50_ms": ttft_p50,
    }
    return shared_useful / static_useful, extra


def sched_phase(device) -> dict:
    """Config 3's scheduler leg: the multi-tenant day under seeded wire
    chaos. The scheduler parks a live training shard at the serving peak
    (snapshot barrier, then the park under the manifest), lends its slot to
    the serving tenant and resumes the shard bit for bit off-peak
    (checkpoint and exactly-once WAL replay, a newer life of the rank).
    Priced as preempt and resume MTTR and as aggregate goodput (training
    slot-seconds and serving tokens) of the shared fleet against two static
    half-fleets over the same measured day."""
    import tempfile

    from distributed_ml_pytorch_tpu_torch.coord.drill import default_drill_plan, sched_drill

    with tempfile.TemporaryDirectory(prefix="bench_sched_") as d:
        out = sched_drill(base_dir=d, seed=0, plan=default_drill_plan(0), device=device)
    s = out["sched"]
    if not out["ok"] or not s["preempt_mttr_s"] or not s["resume_mttr_s"]:
        raise RuntimeError(f"sched_phase incomplete: ok={out['ok']} violations="
                           f"{out['violations']} errors={out['errors']} "
                           f"events={out['events'][-5:]}")
    preempt_mttr = s["preempt_mttr_s"][0]
    resume_mttr = s["resume_mttr_s"][0]
    hw = _fleet_hw(device)
    emit(3, "sched_preempt_mttr", preempt_mttr * 1e3, "ms", hw,
         "serving demand spike -> snapshot barrier -> PreemptRequest -> live training shard "
         "parks under the FleetManifest and its slot is granted to the serving tenant; 2 "
         "workers + 2 shards, LeNet, under seeded wire chaos (coord/sched.FleetScheduler via "
         "coord/drill.sched_drill)")
    emit(3, "sched_resume_mttr", resume_mttr * 1e3, "ms", hw,
         "off-peak revoke -> ResumeRequest -> fresh server restores the manifest checkpoint "
         f"+ replays {out['replayed_updates']} WAL record(s) exactly once (bit-identical: "
         f"{out['bit_identical']}) and rejoins as a newer incarnation of the same rank")
    serve_rate, ttft_p50 = _serving_slot_rate(device)
    uplift, extra = sched_goodput(out, serve_rate, ttft_p50)
    res = {"sched_preempt_mttr": preempt_mttr * 1e3, "sched_resume_mttr": resume_mttr * 1e3,
           "sched_goodput_uplift": uplift}
    emit(3, "sched_goodput_uplift", uplift, "x", "derived",
         "demand-weighted useful slot-seconds, shared FleetScheduler vs two statically "
         "partitioned half-fleets over the SAME measured day: static dedicates one slot to "
         "serving that only has live demand during the peak window, shared lends the "
         "training slot at peak (preempt) and takes it back off-peak (resume), paying only "
         "the measured MTTRs; serving tokens priced at a real ServingEngine's measured burst "
         "rate", extra=extra)
    log(f"sched_phase: preempt {preempt_mttr * 1e3:.0f} ms, resume {resume_mttr * 1e3:.0f} "
        f"ms, day {extra['day_s']}s (peak {extra['peak_window_s']}s), goodput uplift "
        f"{uplift:.2f}x, replayed {out['replayed_updates']}, chaos {out['chaos_counts']}")
    return res


def gray_phase(device) -> dict:
    """Config 3's gray-failure leg: the same windowed one-way partition (the
    workers' pull requests toward shard 0 vanish while its renewals flow)
    run contained (the ladder detects on the workers' link evidence, parks
    the victim and resumes it bit for bit) and unmanaged (no one acts).
    Priced as the gray slice's central aggregation rate, the detection
    latency and the containment MTTR; the latency is held to the root
    ``bench_floors.json``'s ceiling."""
    import json
    import tempfile

    from distributed_ml_pytorch_tpu_torch.coord.drill import gray_drill

    steps, n_workers = 170, 2
    with tempfile.TemporaryDirectory(prefix="bench_gray_on_") as d:
        on = gray_drill(base_dir=d, seed=0, steps=steps, n_workers=n_workers, device=device)
    if (not on["ok"] or on["detect_latency_s"] is None or on["containment_mttr_s"] is None
            or on["fixed_wall_s"] is None):
        raise RuntimeError(f"gray_phase incomplete (containment leg): ok={on['ok']} "
                           f"errors={on['errors']} violations={on['violations']}")
    with tempfile.TemporaryDirectory(prefix="bench_gray_off_") as d:
        off = gray_drill(base_dir=d, seed=0, steps=steps, n_workers=n_workers, contain=False,
                         device=device)
    if not off["ok"] or off["fixed_wall_s"] is None:
        raise RuntimeError(f"gray_phase incomplete (unmanaged leg): ok={off['ok']} "
                           f"errors={off['errors']} violations={off['violations']}")
    fixed = steps * n_workers
    goodput_on = fixed / on["fixed_wall_s"]
    goodput_off = fixed / off["fixed_wall_s"]
    # raw steps/s barely moves (the workers keep stepping on local SGD):
    # containment protects the central aggregation on the gray slice
    central_on = sum(on["applied"][0].values()) / on["wall_s"]
    central_off = sum(off["applied"][0].values()) / off["wall_s"]
    hw = _fleet_hw(device)
    host = " (host clock; LeNet workers, in-process fleet)"
    emit(3, "gray_victim_slice_goodput_contained", central_on, "applied updates/s", hw,
         "central aggregation rate on the gray slice with the ladder live: the park trades "
         "some episode throughput for a bounded recovery (victim on probation in "
         f"{on['detect_latency_s'] * 1e3:.0f} ms, parked, resumed bit_identical="
         f"{on['bit_identical']}, ladder cleared, evictions={on['gray']['evictions']}) vs "
         f"{central_off:.1f} applied/s unmanaged; raw worker steps/s {goodput_on:.1f} vs "
         f"{goodput_off:.1f} over the identical {fixed}-step fixed script (local SGD keeps "
         "raw stepping alive either way) — coord/drill.gray_drill" + host)
    emit(3, "gray_victim_slice_goodput_unmanaged", central_off, "applied updates/s", hw,
         "the comparison leg: the identical gray episode with suspicion pinned off; the "
         "victim slice grinds on retransmit back-off for the whole episode" + host)
    emit(3, "gray_detect_latency", on["detect_latency_s"] * 1e3, "ms", hw,
         "gray onset (first suspicious tick) -> victim on probation, confirmed over 2 "
         "suspicious ticks of the workers' link evidence" + host)
    emit(3, "gray_containment_mttr", on["containment_mttr_s"] * 1e3, "ms", hw,
         "probation -> checkpoint-parked through the gray-granted preempt (snapshot "
         "barrier, logged park ticket); the victim never lease-expires and is never "
         "revoked" + host)
    floors = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "bench_floors.json")
    with open(floors) as fh:
        ceiling = json.load(fh)["gray_detection_latency_ceiling_s"]
    log(f"gray_phase: victim slice {central_on:.1f} vs {central_off:.1f} applied/s, raw "
        f"{goodput_on:.1f} vs {goodput_off:.1f} steps/s (contained vs unmanaged), detect "
        f"{on['detect_latency_s'] * 1e3:.0f} ms (ceiling {ceiling} s), mttr "
        f"{on['containment_mttr_s'] * 1e3:.0f} ms, chaos {on['chaos_counts']}")
    if on["detect_latency_s"] > ceiling:
        raise RuntimeError(f"gray detection latency {on['detect_latency_s']:.2f}s exceeds the "
                           f"{ceiling}s ceiling in bench_floors.json")
    return {"gray_victim_slice_goodput_contained": central_on,
            "gray_victim_slice_goodput_unmanaged": central_off,
            "gray_detect_latency": on["detect_latency_s"] * 1e3,
            "gray_containment_mttr": on["containment_mttr_s"] * 1e3}


# ------------------------------------------------------------------ the mesh legs

MESH_HW = "cpu, gloo"


def mpmd_phase(device, tiny: bool = False) -> dict:
    """Config 3's MPMD pipeline leg: a 4-stage pipeline of fleet members on
    the reliable in-process wire, priced fault-free (tokens/s, the bubble
    fraction and its attribution from the flight recorders' dumps) and
    through a middle stage's death (the restart MTTR and the driver's step
    rate before, during and after)."""
    import tempfile

    from distributed_ml_pytorch_tpu_torch.analysis import timeline
    from distributed_ml_pytorch_tpu_torch.coord.stages import mpmd_scenario

    steps, kill_at, snap_at = (8, 3, 1) if tiny else (16, 6, 2)
    n_stages, M, mb, seq = 4, 4, 4, 8
    shape = dict(n_stages=n_stages, n_microbatches=M, mb=mb, seq=seq, device=device)
    hw = _fleet_hw(device)

    def run(**kw):
        with tempfile.TemporaryDirectory(prefix="bench_mpmd_") as d:
            out = mpmd_scenario(base_dir=d, seed=0, **shape, **kw)
            out["timeline"] = timeline.analyze(out["obs_dir"])
        if not out["ok"] or out["wall_s"] is None:
            raise RuntimeError(f"mpmd_phase incomplete: ok={out['ok']} errors={out['errors']} "
                               f"events={out['events'][-5:]}")
        return out

    run(steps=2 if tiny else 4)  # warm-up
    out = run(steps=steps)
    tok_per_step = M * mb * seq
    res = {"mpmd_pipeline_steady": tok_per_step * (steps - 1) / out["wall_s"],
           "mpmd_bubble_fraction": 100.0 * max(0.0, 1.0 - out["busy_s"]
                                               / (n_stages * out["wall_s"]))}
    emit(3, "mpmd_pipeline_steady", res["mpmd_pipeline_steady"], "tokens/sec", hw,
         f"{n_stages}-stage MPMD pipeline (per-stage programs over ReliableTransport), "
         f"M={M} microbatches of {mb}x{seq} tokens; driver step cadence over {steps} "
         "fault-free steps (coord/stages.mpmd_scenario)")
    # the flight recorders' decomposition of that bubble, schema-gated
    attribution = None
    try:
        attribution = check_bubble_attribution(out["timeline"]["bubble_attribution"])
        res["bubble_attribution"] = attribution
    except (ValueError, KeyError) as e:
        log(f"mpmd_phase: bubble attribution unavailable: {e!r}")
    emit(3, "mpmd_bubble_fraction", res["mpmd_bubble_fraction"], "%", hw,
         "1 - sum(stage busy s) / (stages x wall s) over the steady run: the idle share "
         "of stage-seconds (schedule bubble + wire wait); bubble_attribution decomposes it "
         "per flight-recorder state (analysis/timeline.py over the run's dumps)",
         extra=({"bubble_attribution": attribution} if attribution is not None else None))

    out = run(steps=steps, kill_stage=1, kill_at_step=kill_at, snapshot_at_step=snap_at)
    if out["stage_mttr_s"] is None:
        raise RuntimeError(f"mpmd_phase: no stage restart measured: {out['events'][-5:]}")
    res["mpmd_stage_restart_mttr"] = out["stage_mttr_s"] * 1e3
    emit(3, "mpmd_stage_restart_mttr", res["mpmd_stage_restart_mttr"], "ms", hw,
         f"middle stage killed at its step {kill_at} (silent; lease expiry detection) -> "
         "checkpoint restart -> StageReady; watermark-bounded replay refilled the in-flight "
         f"microbatches (applied accounting {'OK' if out['applied_ok'] else 'BROKEN'}: no "
         "microbatch applied twice)")
    ts = out["step_times"]

    def rate(a, b):
        if b - a < 2 or b > len(ts):
            return None
        return tok_per_step * (b - 1 - a) / (ts[b - 1] - ts[a])

    for name, value, win in (
            ("before", rate(1, kill_at), f"steps 1-{kill_at}"),
            ("during", rate(kill_at, kill_at + 4),
             f"steps {kill_at}-{kill_at + 4} (kill -> lease expiry -> restart -> replay)"),
            ("after", rate(kill_at + 4, steps), f"steps {kill_at + 4}-{steps}")):
        if value is None:
            log(f"mpmd_phase: window {name} too short to rate")
            continue
        res[f"mpmd_stage_kill_throughput_{name}"] = value
        emit(3, f"mpmd_stage_kill_throughput_{name}", value, "tokens/sec", hw,
             f"driver step-completion rate {win}; 4-stage pipeline, middle stage killed and "
             "restarted from its checkpoint")
    log(f"mpmd_phase: kill leg driver stats {out['driver_stats']}, events "
        f"{out['events'][-3:]}")
    return res


def _alexnet_flat() -> torch.Tensor:
    return ravel_model_params(get_model("alexnet", seed=0, device="cpu")).float()


def psum_rank(rank: int, n: int, port: str, rounds: int) -> None:
    """One process of ``allreduce_{n}process_gloo_exchange_rate``: its
    distinct multiple of the raveled AlexNet gradient all-reduced ``rounds``
    times on the CPU over gloo, the sum checked; prints its rate."""
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import data_mesh, init_distributed

    torch.set_num_threads(1)
    mesh = data_mesh(world=init_distributed("gloo", "localhost", port, n, rank, device="cpu"))
    flat = _alexnet_flat()
    g = (rank + 1) * flat
    out = mesh.all_reduce(g.clone(), "data")
    np.testing.assert_allclose(out.numpy(), (flat * (n * (n + 1) / 2)).numpy(), rtol=1e-6)
    t0 = time.perf_counter()
    for _ in range(rounds):
        mesh.all_reduce(g.clone(), "data")
    dt = time.perf_counter() - t0
    print(f"PSUM-OK proc={rank} n_elems={flat.numel()} rate={rounds / dt:.3f}", flush=True)


def mesh_phase(device, tiny: bool = False) -> dict:
    """The mesh legs (see the module docstring); returns ``{metric: value}``.
    They run on the CPU whatever ``device`` is, as the JAX legs ran off the
    TPU."""
    from distributed_ml_pytorch_tpu_torch.launch import _free_port
    from distributed_ml_pytorch_tpu_torch.parallel.sync import (
        make_sync_train_step,
        replicate,
        shard_batch,
    )
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded

    out = {}
    flat = _alexnet_flat()
    iters = 5 if tiny else 50

    def exchange(world):
        mesh = make_mesh(world=world)
        g = flat if world.rank == 0 else -0.5 * flat
        mesh.all_reduce(g.clone(), "data")
        t0 = time.perf_counter()
        for _ in range(iters):
            mesh.all_reduce(g.clone(), "data")
        return iters / (time.perf_counter() - t0)

    rate = min(run_threaded(2, exchange))
    mb = flat.numel() * 4 / 1e6
    out["allreduce_2way_gradient_exchange_rate"] = rate
    emit(2, "allreduce_2way_gradient_exchange_rate", rate, "exchanges/sec",
         f"2 gloo ranks as threads, {MESH_HW}",
         f"all_reduce of the {flat.numel()}-elem raveled AlexNet gradient ({mb:.1f} MB) "
         f"between two gloo ranks that are threads of one process on the CPU (the JAX "
         f"leg's two virtual cpu devices), {iters} rounds; off the card, as the JAX leg "
         f"was off the TPU")

    batch, steps = (8, 1) if tiny else (64, 5)

    def dp(world):
        torch.set_num_threads(1)
        mesh = make_mesh(world=world)
        model = get_model("resnet18", seed=0, device="cpu")
        tx = SGD(0.05)
        state = replicate(mesh, create_train_state(model, tx))
        step = make_sync_train_step(model, tx, mesh)
        images, labels = make_batch(batch)
        bx, by = shard_batch(mesh, images, labels)
        _, loss = step(state, bx, by)
        t0 = time.perf_counter()
        for _ in range(steps):
            _, loss = step(state, bx, by)
        return time.perf_counter() - t0, float(loss)

    threads = torch.get_num_threads()
    try:
        res = run_threaded(8, dp, timeout_s=600.0)
    finally:
        torch.set_num_threads(threads)
    dt = max(r[0] for r in res)
    out["resnet18_8way_dp_step_throughput"] = steps * batch / dt
    emit(4, "resnet18_8way_dp_step_throughput", steps * batch / dt, "images/sec",
         f"8 gloo ranks as threads, {MESH_HW}",
         f"global batch {batch} over 8-way sync DP (the gradient mean an all_reduce over "
         f"gloo), 8 threads of one process on the CPU at one intra-op thread each (the JAX "
         f"leg's 8 virtual cpu devices), loss={res[0][1]:.3f} — functional validation of "
         f"the sharded step off the card, as the JAX leg was off the TPU")

    n, rounds = 4, (3 if tiny else 20)
    port = _free_port()
    code = ("import sys; from distributed_ml_pytorch_tpu_torch import bench_all; "
            "bench_all.psum_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
            "int(sys.argv[4]))")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(n), port, str(rounds)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(n)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    rates = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"PSUM-OK proc={r}" not in text:
            raise RuntimeError(f"allreduce process {r} failed:\n{text[-2000:]}")
        rates.append(float(text.split("rate=")[1].split()[0]))
    metric = f"allreduce_{n}process_gloo_exchange_rate"
    out[metric] = min(rates)
    emit(2, metric, min(rates), "exchanges/sec", f"{n} gloo processes, {MESH_HW}",
         f"all_reduce of the {flat.numel()}-elem raveled AlexNet gradient ({mb:.1f} MB) "
         f"across {n} localhost processes over gloo on the CPU, result checked = the sum of "
         f"all ranks; the slowest rank's rate over {rounds} rounds; off the card, as the "
         f"JAX leg was off the TPU")
    return out


LEGS = {
    "alexnet": lambda dev, tiny: alexnet_phase(dev, tiny=tiny),
    "lm": lambda dev, tiny: lm_phase(dev, tiny=tiny),
    "conv_epilogue": lambda dev, tiny: compute_microbench_phase(dev, batch=16 if tiny else 256),
    "ps": lambda dev, tiny: ps_phase(dev, tiny=tiny),
    "sharded_ps": lambda dev, tiny: sharded_ps_phase(dev, tiny=tiny),
    "transport": lambda dev, tiny: transport_phase(dev, tiny=tiny),
    "lm_32k": lambda dev, tiny: lm_32k_phase(dev, tiny=tiny),
    "steps_to_accuracy": lambda dev, tiny: steps_to_accuracy_phase(dev, tiny=tiny),
    "reliability": lambda dev, tiny: reliability_phase(dev, tiny=tiny),
    "wire_bytes": lambda dev, tiny: wire_bytes_phase(dev, tiny=tiny),
    "elastic": lambda dev, tiny: elastic_phase(dev, tiny=tiny),
    "recovery": lambda dev, tiny: recovery_phase(dev),
    "coordfail": lambda dev, tiny: coordfail_phase(dev),
    "health": lambda dev, tiny: health_phase(dev),
    "sched": lambda dev, tiny: sched_phase(dev),
    "gray": lambda dev, tiny: gray_phase(dev),
    "mpmd": lambda dev, tiny: mpmd_phase(dev, tiny=tiny),
    "resnet": lambda dev, tiny: resnet_phase(dev, tiny=tiny),
    "moe": lambda dev, tiny: moe_phase(dev, tiny=tiny),
    "decode": lambda dev, tiny: decode_phase(dev, tiny=tiny),
    "mesh": lambda dev, tiny: mesh_phase(dev, tiny=tiny),
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
