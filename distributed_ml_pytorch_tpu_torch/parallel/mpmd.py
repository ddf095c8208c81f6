"""MPMD pipeline parallelism: each stage its own program and its own fleet
member (counterpart of the JAX ``parallel/mpmd.py``).

``parallel/pipeline.py`` runs a schedule as one world whose stages step
together: one stage's fault stops the model. Here each stage runs its own
programs, and activations and their cotangents travel between stages as
wire messages, so a stage is a unit the coordination plane (``coord/``)
already leases, places, detects dead and restarts:

- :class:`StagePrograms`: one stage's programs (forward, recompute
  backward, the last stage's fused loss and backward, the SGD update) over a
  stage module built once per key and run with ``torch.func.functional_call``
  on the caller's parameters. Stage 0 also owns the token and position
  embeddings, the last stage ``ln_f`` and the head, so the stages' parameter
  counts concatenate, in stage order, into the contiguous ranges of
  :func:`stage_param_ranges` that ``ShardMap`` and ``FleetManifest`` carry.
- :class:`MpmdLocal`: the same numerics in one thread, no transport: the
  oracle. Each stage's gradients are the plain autograd gradients of the
  reference model.
- :class:`MpmdStage`: one stage as a fleet member: a serve loop over a
  :class:`~.messaging.Transport` (so ``ReliableTransport`` and the chaos
  wrappers wrap it unchanged), a ``CoordClient`` lease, a receive dedup per
  ``(step, microbatch)`` (no microbatch is applied twice, whatever chaos
  duplicates, the reliable layer redelivers or a restart replays), a
  retained-send buffer for the watermark replay toward restarted neighbours,
  and a stage checkpoint (parameters, optimizer state, watermark) written
  through ``utils/durability.atomic_write`` after every update and reported
  into the ``FleetManifest`` snapshot barrier.
- :class:`MpmdDriver`: the data feeder and loss collector: it ships each
  microbatch's tokens to stage 0 and its targets to the last stage
  (``ActivationShip`` kinds 1 and 2), collects the ``ce_sum`` reports (kind
  3), and re-ships retained data to restarted endpoints.

The restart contract: a stage checkpoints after every update, so its
watermark is ``step * M``, the count of microbatches whose gradients its
parameters hold. When it dies the coordinator (``coord/stages.py``) vacates
its entry of the versioned ``StagePlacement``; a replacement announces
``StageReady(stage, watermark)`` and the coordinator broadcasts the new
placement. A member whose neighbour's entry changed incarnation re-ships
the retained ``(step, mb)`` messages at or past that entry's watermark.
Receivers dedup by ``(step, mb)``, so replay and redelivery only fill
holes, and each step's update is the microbatch-ordered sum of the
microbatch gradients: the recovered trajectory is the fault-free one.

Scheduling: a stage runs only its own current step (its forward for step
``t`` must see its parameters after update ``t - 1``); within a step the
microbatches pipeline freely, backwards running as their cotangents
arrive. A straggling stage can be raced by a standby member that loads its
checkpoint (``coord/stages.py``).

On a CUDA tensor each block's attention is ``ops.attention``'s flash
kernels (float32: ``csrc/attention.cu``): K4 in every stage forward and in
each recompute, K5 in each backward.

The flight recorder (``recorder=``, ``obs_dir=``): a stage attributes its
serve loop's wall clock to exclusive states (compute, wait-act, wait-grad,
wire-blocked, ckpt, idle) with a ``utils/obs.StateClock``, each
microbatch's work runs under the correlation id the driver minted for it
(it rides the reliable envelope), and a stage dumps its ring to
``obs_dir`` at its death and at its stop, the driver at its stop.
``analysis/timeline.py`` turns those dumps into the bubble's attribution.
The recorder reads host clocks only and steers nothing.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from distributed_ml_pytorch_tpu_torch.device import resolve_device
from distributed_ml_pytorch_tpu_torch.models.transformer import Dense, Embed, LayerNorm
from distributed_ml_pytorch_tpu_torch.parallel.pipeline import (
    PipelineLM,
    PipelineLMConfig,
    init_pp_params,
)
from distributed_ml_pytorch_tpu_torch.utils import codecs
from distributed_ml_pytorch_tpu_torch.utils.compress import (
    CODEC_DENSE,
    CODEC_INT8,
    CompressionError,
)
from distributed_ml_pytorch_tpu_torch.utils.durability import atomic_write
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    MessageCode,
    Transport,
    _join16,
    _split16,
)
from distributed_ml_pytorch_tpu_torch.utils.metrics import Ewma
from distributed_ml_pytorch_tpu_torch.utils.obs import (
    StateClock,
    corr_scope,
    current_corr,
    flight_dump,
    next_corr,
)

_LOGGER = logging.getLogger(__name__)

#: ``ActivationShip`` payload kinds (``WIRE_SCHEMAS``): what the body carries
SHIP_ACT = 0      # activation, stage s -> s+1
SHIP_TOKENS = 1   # a microbatch's token ids, driver -> stage 0
SHIP_TARGETS = 2  # a microbatch's target ids, driver -> last stage
SHIP_LOSS = 3     # [ce_sum], last stage -> driver

CKPT_FILE = "stage.ckpt"


def replay_covers(step: int, mbi: int, n_microbatches: int, watermark: int) -> bool:
    """Whether a retained ``(step, mb)`` hand-off is re-shipped to a
    restarted neighbour: its global microbatch index is AT OR PAST the
    neighbour's watermark. ``>=`` is load-bearing: the checkpoint at
    watermark ``w`` holds the indices below ``w``, so ``w`` itself is the
    restarted member's first hole, and re-shipping only above it would leave
    a gap for good."""
    return step * n_microbatches + mbi >= watermark


# ------------------------------------------------------------------ parameters

def stage_layer_slice(cfg: PipelineLMConfig, stage: int, n_stages: int) -> Tuple[int, int]:
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} must divide evenly over {n_stages} stages")
    per = cfg.n_layers // n_stages
    return stage * per, (stage + 1) * per


def stage_param_tree(cfg: PipelineLMConfig, full: Dict[str, torch.Tensor], stage: int,
                     n_stages: int) -> Dict[str, torch.Tensor]:
    """The part of a whole :func:`~.pipeline.init_pp_params` ``state_dict``
    that one stage owns, copied: its blocks (renumbered from 0), and the
    embeddings (stage 0) and ``ln_f`` and the head (the last stage)."""
    lo, hi = stage_layer_slice(cfg, stage, n_stages)
    out = {}
    for name, t in full.items():
        owner = name.split(".", 1)[0]
        if owner == "blocks":
            _, i, rest = name.split(".", 2)
            if lo <= int(i) < hi:
                out[f"blocks.{int(i) - lo}.{rest}"] = t.detach().clone()
        elif owner in ("tok_embed", "pos_embed"):
            if stage == 0:
                out[name] = t.detach().clone()
        elif stage == n_stages - 1:
            out[name] = t.detach().clone()
    return out


def init_stage_params(cfg: PipelineLMConfig, seed: int, stage: int, n_stages: int
                      ) -> Dict[str, torch.Tensor]:
    """Every member draws the WHOLE model from the same seed and keeps its
    stage: the stages of a fleet always assemble into one model."""
    return stage_param_tree(cfg, init_pp_params(cfg, seed), stage, n_stages)


def assemble_full_params(cfg: PipelineLMConfig, stage_trees) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`stage_param_tree` over all the stages."""
    out = {}
    lo = 0
    for tree in stage_trees:
        per = 0
        for name, t in tree.items():
            if name.startswith("blocks."):
                _, i, rest = name.split(".", 2)
                out[f"blocks.{lo + int(i)}.{rest}"] = t
                per = max(per, int(i) + 1)
            else:
                out[name] = t
        lo += per
    return out


def stage_param_ranges(cfg: PipelineLMConfig, n_stages: int) -> List[Tuple[int, int]]:
    """The contiguous ``[lo, hi)`` of each stage's parameters in the
    stage-ordered concatenation: the ranges the coordinator's
    ``StagePlacement`` and the ``FleetManifest`` barrier carry (the JAX
    ranges, element for element)."""
    stage_layer_slice(cfg, 0, n_stages)  # divisibility
    per = cfg.n_layers // n_stages
    with torch.device("meta"):
        model = PipelineLM(cfg, n_blocks=1)

    def size(module: nn.Module) -> int:
        return sum(p.numel() for p in module.parameters())

    blocks = per * size(model.blocks[0])
    ranges, cursor = [], 0
    for s in range(n_stages):
        n = blocks
        if s == 0:
            n += size(model.tok_embed) + size(model.pos_embed)
        if s == n_stages - 1:
            n += size(model.ln_f) + size(model.head)
        ranges.append((cursor, cursor + n))
        cursor += n
    return ranges


# -------------------------------------------------------------------- programs

class StageLM(nn.Module):
    """One stage's modules, under :class:`~.pipeline.PipelineLM`'s names:
    ``tok_embed`` and ``pos_embed`` (the first stage), its ``blocks``,
    ``ln_f`` and the ``head`` (the last). ``forward(x)`` is the stage output;
    ``forward(x, targets)`` (the last stage) the masked CE sum."""

    def __init__(self, cfg: PipelineLMConfig, n_blocks: int, first: bool, last: bool):
        super().__init__()
        self.first, self.last = first, last
        if first:
            self.tok_embed = Embed(cfg.vocab_size, cfg.d_model)
            self.pos_embed = Embed(cfg.max_len, cfg.d_model)
        self.blocks = nn.ModuleList([cfg.block() for _ in range(n_blocks)])
        if last:
            self.ln_f = LayerNorm(cfg.d_model)
            self.head = Dense(cfg.d_model, cfg.vocab_size, bias=False)

    def forward(self, x, targets=None):
        if self.first:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
            h = self.tok_embed(x) + self.pos_embed(positions)
        else:
            h = x
        for blk in self.blocks:
            h = blk(h)
        if targets is None:
            return h
        logits = self.head(self.ln_f(h))
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                             reduction="none").reshape(targets.shape)
        mask = torch.ones_like(ce)
        mask[:, -1] = 0.0
        return torch.sum(ce * mask)


class StagePrograms:
    """One stage's programs (see the module docstring), each a function of
    the parameters it is given (a ``state_dict`` of :class:`StageLM`):

    - ``fwd(params, x) -> h_out`` under ``torch.no_grad()``; ``x`` is the
      tokens (stage 0) or the received activation;
    - ``bwd(params, x, g) -> (d_params, d_x)`` recomputes the stage forward
      under autograd: no residual is kept across messages, which is what
      makes the watermark replay a pure recompute. Stage 0's ``d_x`` is a
      zero scalar (integer tokens);
    - the last stage's ``loss_bwd(params, x, targets) -> (ce_sum, d_params,
      d_x)`` fuses forward, loss and backward, seeded with ``1 / (n_mask *
      M)`` (the final position of each sequence is masked), so the sum of
      the microbatch gradients is the gradient of the global mean loss; a
      one-stage ``d_x`` is a zero scalar;
    - ``update(params, opt_state, grads) -> (params, opt_state)`` is plain
      SGD, in place (``p + (-lr * g)``, optax ``sgd``'s two roundings); its
      state is empty.

    The stage module is built once on the meta device; a call swaps the
    caller's tensors in (``functional_call``) under the programs' lock, so
    two members of one stage (a speculation race) take turns."""

    def __init__(self, cfg: PipelineLMConfig, stage: int, n_stages: int,
                 n_microbatches: int, lr: float):
        self.cfg = cfg
        self.stage = int(stage)
        self.n_stages = int(n_stages)
        self.first = stage == 0
        self.last = stage == n_stages - 1
        self.M = int(n_microbatches)
        self.lr = float(lr)
        lo, hi = stage_layer_slice(cfg, stage, n_stages)
        with torch.device("meta"):
            self.module = StageLM(cfg, hi - lo, self.first, self.last)
        self._lock = threading.Lock()

    def fwd(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        with self._lock, torch.no_grad():
            return functional_call(self.module, params, (x,))

    def _leaves(self, params):
        return {k: v.detach().requires_grad_() for k, v in params.items()}

    def bwd(self, params, x, g):
        with self._lock:
            p = self._leaves(params)
            if self.first:
                h = functional_call(self.module, p, (x,))
                grads = torch.autograd.grad(h, list(p.values()), g)
                return dict(zip(p, grads)), torch.zeros((), device=g.device)
            xi = x.detach().requires_grad_()
            h = functional_call(self.module, p, (xi,))
            *grads, d_x = torch.autograd.grad(h, [*p.values(), xi], g)
            return dict(zip(p, grads)), d_x

    def loss_bwd(self, params, x, targets):
        if not self.last:
            raise ValueError(f"stage {self.stage} of {self.n_stages} has no loss")
        n_mask = targets.shape[0] * (targets.shape[1] - 1)
        with self._lock:
            p = self._leaves(params)
            xi = x if self.first else x.detach().requires_grad_()
            ce_sum = functional_call(self.module, p, (xi, targets))
            seed = torch.tensor(1.0 / float(n_mask * self.M), dtype=ce_sum.dtype,
                                device=ce_sum.device)
            wrt = list(p.values()) if self.first else [*p.values(), xi]
            grads = torch.autograd.grad(ce_sum, wrt, seed)
        if self.first:
            return ce_sum.detach(), dict(zip(p, grads)), torch.zeros((), device=x.device)
        return ce_sum.detach(), dict(zip(p, grads[:-1])), grads[-1]

    def update(self, params, opt_state, grads):
        with torch.no_grad():
            for name, t in params.items():
                t.add_(grads[name] * -self.lr)
        return params, opt_state


_PROGRAM_CACHE: Dict[tuple, StagePrograms] = {}
_PROGRAM_LOCK = threading.Lock()


def stage_programs(cfg: PipelineLMConfig, stage: int, n_stages: int, n_microbatches: int,
                   lr: float) -> StagePrograms:
    """The process-wide cache of stage programs: a restarted member of a
    stage (or a repeat run) reuses the programs already built."""
    key = (cfg.vocab_size, cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff, cfg.max_len,
           int(stage), int(n_stages), int(n_microbatches), float(lr))
    with _PROGRAM_LOCK:
        prog = _PROGRAM_CACHE.get(key)
        if prog is None:
            prog = _PROGRAM_CACHE[key] = StagePrograms(cfg, stage, n_stages,
                                                       n_microbatches, lr)
        return prog


def _add(acc: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: acc[k] + g[k] for k in acc}


def _long(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).long().to(device)


# ----------------------------------------------------------------- local runner

class MpmdLocal:
    """The MPMD step in one thread: the oracle.

    ``schedule`` orders the host's work only: ``"gpipe"`` runs every
    microbatch forward, then the backwards; ``"1f1b"`` runs each microbatch's
    forward and backward depth first. The values per microbatch are the same
    and each stage sums its microbatch gradients in microbatch order either
    way, so the two schedules give the same update. ``params`` is a whole
    :func:`~.pipeline.init_pp_params` ``state_dict`` (drawn from ``seed``
    when None)."""

    def __init__(self, cfg: PipelineLMConfig, n_stages: int, n_microbatches: int, lr: float,
                 seed: int = 0, schedule: str = "gpipe", *,
                 params: Optional[Dict[str, torch.Tensor]] = None, device="cuda"):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"schedule must be 'gpipe' or '1f1b', got {schedule!r}")
        self.cfg = cfg
        self.S = int(n_stages)
        self.M = int(n_microbatches)
        self.schedule = schedule
        self.device = resolve_device(device)
        full = params if params is not None else init_pp_params(cfg, seed)
        self.params = [{k: v.to(self.device) for k, v in
                        stage_param_tree(cfg, full, s, self.S).items()}
                       for s in range(self.S)]
        self.programs = [stage_programs(cfg, s, self.S, self.M, lr) for s in range(self.S)]
        self.opt_states = [() for _ in range(self.S)]

    def _forward(self, mbi, tokens_mb, inputs):
        x = _long(tokens_mb[mbi], self.device)
        for s in range(self.S - 1):
            inputs[s][mbi] = x
            x = self.programs[s].fwd(self.params[s], x)
        inputs[self.S - 1][mbi] = x

    def _backward(self, mbi, targets_mb, inputs, grads) -> float:
        S = self.S
        ce_sum, d_params, g = self.programs[S - 1].loss_bwd(
            self.params[S - 1], inputs[S - 1][mbi], _long(targets_mb[mbi], self.device))
        grads[S - 1][mbi] = d_params
        for s in range(S - 2, -1, -1):
            d_params, g = self.programs[s].bwd(self.params[s], inputs[s][mbi], g)
            grads[s][mbi] = d_params
        return float(ce_sum)

    def step(self, tokens_mb, targets_mb) -> float:
        """One update over ``(M, mb, seq)`` microbatches; the global mean
        masked CE (``pipeline.py``'s convention)."""
        M, S = self.M, self.S
        mb, seq = tokens_mb.shape[1], tokens_mb.shape[2]
        inputs = [dict() for _ in range(S)]
        grads = [dict() for _ in range(S)]
        ce_total = 0.0
        if self.schedule == "gpipe":
            for mbi in range(M):
                self._forward(mbi, tokens_mb, inputs)
            for mbi in range(M):
                ce_total += self._backward(mbi, targets_mb, inputs, grads)
        else:
            for mbi in range(M):
                self._forward(mbi, tokens_mb, inputs)
                ce_total += self._backward(mbi, targets_mb, inputs, grads)
        for s in range(S):
            acc = grads[s][0]
            for mbi in range(1, M):  # microbatch order: a deterministic sum
                acc = _add(acc, grads[s][mbi])
            self.params[s], self.opt_states[s] = self.programs[s].update(
                self.params[s], self.opt_states[s], acc)
        return ce_total / float(mb * (seq - 1) * M)

    def full_params(self) -> Dict[str, torch.Tensor]:
        return assemble_full_params(self.cfg, self.params)


# ---------------------------------------------------------------- checkpoints

def save_stage_checkpoint(ckpt_dir: str, *, stage: int, step: int, watermark: int, lo: int,
                          hi: int, params_flat: np.ndarray, opt_flat: np.ndarray) -> None:
    """One stage checkpoint: ONE file (a JSON line of meta, then the
    CRC-covered float32 state) published by ONE ``atomic_write``: meta and
    state never tear apart, and two racing writers (a speculation's victim
    and its standby share the stage's directory for a moment) end as
    last-writer-wins, never as a mix."""
    os.makedirs(ckpt_dir, exist_ok=True)
    p = np.ascontiguousarray(params_flat, np.float32)
    o = np.ascontiguousarray(opt_flat, np.float32)
    meta = {
        "stage": int(stage), "step": int(step), "watermark": int(watermark),
        "lo": int(lo), "hi": int(hi),
        "n_params": int(p.size), "n_opt": int(o.size),
        # the CRC of the two arrays' bytes back to back, computed in place
        "crc": zlib.crc32(o, zlib.crc32(p)) & 0xFFFFFFFF,
    }
    atomic_write(os.path.join(ckpt_dir, CKPT_FILE),
                 (json.dumps(meta).encode() + b"\n", p.data, o.data))


def load_stage_checkpoint(ckpt_dir: str):
    """``(meta, params_flat, opt_flat)`` of one stage checkpoint;
    ``ValueError`` on a missing, torn or CRC-damaged one: a restart never
    serves state it cannot trust."""
    path = os.path.join(ckpt_dir, CKPT_FILE)
    try:
        with open(path, "rb") as f:
            raw = f.read()
        head, _, blob = raw.partition(b"\n")
        meta = json.loads(head)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"unreadable stage checkpoint in {ckpt_dir}: {e!r}") from e
    if (zlib.crc32(blob) & 0xFFFFFFFF) != int(meta["crc"]):
        raise ValueError(f"stage checkpoint CRC mismatch in {ckpt_dir} — refusing to "
                         "restore corrupt state")
    n_params, n_opt = int(meta["n_params"]), int(meta["n_opt"])
    if len(blob) != 4 * (n_params + n_opt):
        raise ValueError(f"stage checkpoint size mismatch in {ckpt_dir}: {len(blob)} bytes "
                         f"for {n_params}+{n_opt} floats")
    flat = np.frombuffer(blob, np.float32)
    return meta, flat[:n_params].copy(), flat[n_params:].copy()


# ---------------------------------------------------------------- fleet member

class MpmdStage:
    """One pipeline stage as a fleet member (see the module docstring).

    Threads: the serve loop (:meth:`run`) owns the training state; the
    ``CoordClient``'s listener only leaves placements, snapshot requests and
    speculation tasks in mailboxes under ``_mu``. A standby member
    (``stage=None``) idles until a ``SpeculateTask`` names a victim, then
    loads the victim stage's checkpoint from ``ckpt_root`` and races it.
    ``params`` is this stage's initial ``state_dict`` (drawn from ``seed``
    when None); the tensors live on ``device``."""

    def __init__(self, stage: Optional[int], cfg: PipelineLMConfig, n_stages: int,
                 n_microbatches: int, transport: Transport, coord, *, mb_size: int,
                 seq_len: int, lr: float = 0.1, seed: int = 0, ckpt_dir: Optional[str] = None,
                 ckpt_root: Optional[str] = None, driver_rank: int = 0, throttle: float = 0.0,
                 retain_steps: int = 3,
                 step_hook: Optional[Callable[["MpmdStage", int], None]] = None,
                 recorder=None, obs_dir: Optional[str] = None, act_codec: str = "dense",
                 params: Optional[Dict[str, torch.Tensor]] = None, device="cuda"):
        if act_codec not in ("dense", "int8"):
            raise ValueError(f"act_codec must be dense|int8, got {act_codec}")
        self.cfg = cfg
        self.S = int(n_stages)
        self.M = int(n_microbatches)
        self.transport = transport
        self.coord = coord
        self.rank = transport.rank
        self.mb_size = int(mb_size)
        self.seq_len = int(seq_len)
        self.lr = float(lr)
        self.seed = int(seed)
        self.ckpt_dir = ckpt_dir
        self.ckpt_root = ckpt_root
        self.driver_rank = int(driver_rank)
        self.throttle = float(throttle)
        self.retain_steps = int(retain_steps)
        self.step_hook = step_hook
        self.device = resolve_device(device)
        self.ranges = stage_param_ranges(cfg, self.S)
        #: activation bodies (SHIP_ACT forward, ActivationGrad backward) ride
        #: this codec; tokens, targets and losses are always dense. Retained
        #: buffers hold the raw float32 and are encoded at each send, so a
        #: replayed frame is byte-identical to the first
        self._act_cid = CODEC_INT8 if act_codec == "int8" else CODEC_DENSE

        self.stage: Optional[int] = None
        self.programs: Optional[StagePrograms] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.opt_state = None
        self.step = 0
        if stage is not None:
            self._install_stage(int(stage), params)

        # the serve thread's training state, by step or (step, mb)
        self._inputs: Dict[int, Dict[int, np.ndarray]] = {}
        self._targets: Dict[int, Dict[int, np.ndarray]] = {}
        self._gin: Dict[int, Dict[int, np.ndarray]] = {}
        self._done_fwd: Dict[int, set] = {}
        self._done_bwd: Dict[int, set] = {}
        self._mb_grads: Dict[int, Dict[int, Dict[str, torch.Tensor]]] = {}
        #: retained outbound bodies for the watermark replay: dirn -> (step, mb)
        self._retained: Dict[str, Dict[Tuple[int, int], np.ndarray]] = {"fwd": {}, "bwd": {}}
        #: the checkpoint's host copy of the parameters (pinned, on the card)
        self._host_flat: Optional[torch.Tensor] = None
        #: the exactly-once audit of applied (step, mb) pairs, a bounded ring
        self.applied_log = collections.deque(maxlen=4096)
        self._placement = None
        self._superseded = False
        #: the busy milliseconds of each update (the lease renewal's EWMA)
        self._ewma = Ewma()
        self._busy_at_update = 0.0
        self.stats = {
            "fwd": 0, "bwd": 0, "updates": 0, "dup_inputs_dropped": 0,
            "dup_grads_dropped": 0, "stale_dropped": 0, "reshipped": 0,
            "send_failed": 0, "snapshots": 0, "malformed_dropped": 0,
            "busy_s": 0.0, "act_dense_floats": 0, "act_wire_floats": 0,
        }
        #: the flight recorder and its serve loop's exclusive-state clock
        self.recorder = recorder
        self.obs_dir = obs_dir
        self._clock = StateClock(recorder, "idle") if recorder is not None else None
        #: each (step, mb)'s correlation id: adopted from the driver's
        #: frames, so one microbatch is one id on every member
        self._mb_corr: Dict[Tuple[int, int], int] = {}
        #: the mailboxes the coordinator's listener fills and the loop drains
        self._mu = threading.Lock()
        self._placement_mail = None
        self._snap_mail: Optional[Tuple[int, int]] = None
        self._spec_mail: Optional[Tuple[int, int, int]] = None
        if getattr(coord, "on_stage_assign", None) is None:
            coord.on_stage_assign = self._note_placement
        if getattr(coord, "on_snapshot", None) is None:
            coord.on_snapshot = self._note_snapshot
        if getattr(coord, "_on_speculate", None) is None:
            coord._on_speculate = self._note_speculate
        self._stop = threading.Event()
        self._crashed = False
        self.error: Optional[str] = None

    # ------------------------------------------------------------- identity
    @property
    def watermark(self) -> int:
        """The count of global microbatches this member's parameters hold."""
        return self.step * self.M

    @property
    def lo(self) -> int:
        return self.ranges[self.stage][0] if self.stage is not None else 0

    @property
    def hi(self) -> int:
        return self.ranges[self.stage][1] if self.stage is not None else 0

    def _install_stage(self, stage: int, params=None) -> None:
        self.stage = stage
        self.programs = stage_programs(self.cfg, stage, self.S, self.M, self.lr)
        if self.params is None:
            if params is None:
                params = init_stage_params(self.cfg, self.seed, stage, self.S)
            self.params = {k: v.detach().clone().to(self.device) for k, v in params.items()}
            self.opt_state = ()

    # ------------------------------------------------------------ lifecycle
    def crash(self) -> None:
        """Die SILENTLY (a chaos script's hook): the serve loop exits, the
        lease renewals stop, no leave is sent; the coordinator must see the
        death by lease expiry."""
        self._crashed = True
        self.coord.stop()
        self._stop.set()

    def stop(self) -> None:
        self.coord.close()
        self._stop.set()

    # ------------------------------------------------------------ mailboxes
    def _note_placement(self, placement) -> None:
        with self._mu:
            if self._placement_mail is None or placement.version > self._placement_mail.version:
                self._placement_mail = placement

    def _note_snapshot(self, snapshot_id: int, map_version: int) -> None:
        with self._mu:
            self._snap_mail = (int(snapshot_id), int(map_version))

    def _note_speculate(self, task_id: int, victim_rank: int, from_step: int) -> None:
        with self._mu:
            self._spec_mail = (int(task_id), int(victim_rank), int(from_step))

    def _drain_mailboxes(self) -> None:
        with self._mu:
            placement, self._placement_mail = self._placement_mail, None
            snap, self._snap_mail = self._snap_mail, None
            spec, self._spec_mail = self._spec_mail, None
        if placement is not None:
            self._apply_placement(placement)
        if spec is not None:
            self._apply_speculation(*spec)
        if snap is not None:
            self._do_snapshot(*snap)

    # ------------------------------------------------------------ placement
    def _apply_placement(self, placement) -> None:
        from distributed_ml_pytorch_tpu_torch.coord.stages import placement_deltas

        old = self._placement
        self._placement = placement
        if self.stage is not None and self.stage < len(placement.entries):
            e = placement.entries[self.stage]
            if e.rank >= 0 and e.rank != self.rank:
                if not self._superseded:
                    self._superseded = True
                    _LOGGER.info("stage %d member rank %d superseded by rank %d "
                                 "(placement v%d) — going passive",
                                 self.stage, self.rank, e.rank, placement.version)
            elif e.rank == self.rank:
                self._superseded = False
        for e in placement_deltas(old, placement):
            self._reship_to(e)

    def _reship_to(self, entry) -> None:
        """A neighbour's member changed incarnation (a restart or a takeover):
        re-ship the retained traffic at or past its watermark. Receivers dedup
        by ``(step, mb)``, so a replay is idempotent."""
        if self.stage is None or self._superseded:
            return
        if entry.stage == self.stage + 1:
            dirn, code, kind = "fwd", MessageCode.ActivationShip, SHIP_ACT
        elif entry.stage == self.stage - 1:
            dirn, code, kind = "bwd", MessageCode.ActivationGrad, 0
        else:
            return
        for (step, mbi), body in sorted(self._retained[dirn].items()):
            if not replay_covers(step, mbi, self.M, entry.watermark):
                continue
            self._send_frame(entry.rank, code, step, mbi, kind, body)
            self.stats["reshipped"] += 1

    # ----------------------------------------------------------------- wire
    def _placement_version(self) -> int:
        return self._placement.version if self._placement is not None else 0

    def _rank_of_stage(self, stage: int) -> Optional[int]:
        p = self._placement
        if p is None or not (0 <= stage < len(p.entries)):
            return None
        rank = p.entries[stage].rank
        return rank if rank >= 0 else None

    def _send_frame(self, dst_rank: int, code: MessageCode, step: int, mbi: int, kind: int,
                    body: np.ndarray) -> None:
        ver = self._placement_version()
        # activations may ride a lossy codec; tokens, targets and losses are
        # exact by contract
        lossy_ok = (code == MessageCode.ActivationGrad
                    or (code == MessageCode.ActivationShip and kind == SHIP_ACT))
        cid, coded = codecs.encode_body(code, body, self._act_cid if lossy_ok else CODEC_DENSE)
        if lossy_ok:
            self.stats["act_dense_floats"] += int(body.size)
            self.stats["act_wire_floats"] += int(coded.size)
        if code == MessageCode.ActivationShip:
            head = [*_split16(step), float(mbi), float(kind), *_split16(ver), float(cid)]
        else:
            head = [*_split16(step), float(mbi), *_split16(ver), float(cid)]
        # a send blocked at the window or at the receiver's credit is the
        # wire's time, not compute's: carved out of the loop's current state
        stats = getattr(self.transport, "stats", None)

        def blocked_s():
            return (stats.get("window_blocked_s", 0.0) + stats.get("credit_blocked_s", 0.0)
                    if isinstance(stats, dict) else 0.0)

        blocked0 = blocked_s()
        try:
            self.transport.send(code, np.concatenate([np.asarray(head, np.float32),
                                                      coded.ravel()]), dst=dst_rank)
        except (OSError, ConnectionError, KeyError):
            # a dead or vacant peer: the retained buffer and the placement's
            # re-ship own the recovery, the send path must not die
            self.stats["send_failed"] += 1
        if self._clock is not None and isinstance(stats, dict):
            blocked = blocked_s() - blocked0
            if blocked > 0:
                self._clock.carve("wire-blocked", blocked)

    def _ship(self, dirn: str, step: int, mbi: int, body: np.ndarray) -> None:
        """Retain, then send one outbound hand-off; held (retained only)
        while the next stage is vacant. Loss reports are not retained: the
        driver never restarts, and a restarted last stage recomputes and
        resends them (the driver dedups)."""
        body = np.asarray(body, np.float32).ravel()
        if dirn in ("fwd", "bwd"):
            self._retained[dirn][(step, mbi)] = body
        if self._superseded:
            return
        if dirn == "fwd":
            dst = self._rank_of_stage(self.stage + 1)
            code, kind = MessageCode.ActivationShip, SHIP_ACT
        elif dirn == "bwd":
            dst = self._rank_of_stage(self.stage - 1)
            code, kind = MessageCode.ActivationGrad, 0
        else:
            dst = self.driver_rank
            code, kind = MessageCode.ActivationShip, SHIP_LOSS
        if dst is None:
            return
        # the microbatch's correlation id rides the envelope to the peer
        with corr_scope(self._mb_corr.get((step, mbi), 0)):
            self._send_frame(dst, code, step, mbi, kind, body)

    # -------------------------------------------------------------- receive
    def handle(self, sender: int, code: MessageCode, payload: np.ndarray) -> None:
        if code == MessageCode.ActivationShip and payload.size >= 8:
            if not np.isfinite(payload[:7]).all():
                return
            step, mbi = _join16(payload[0], payload[1]), int(payload[2])
            self._adopt_corr(step, mbi)
            self._on_ship(step, mbi, int(payload[3]), int(payload[6]), payload[7:])
        elif code == MessageCode.ActivationGrad and payload.size >= 7:
            if not np.isfinite(payload[:6]).all():
                return
            step, mbi = _join16(payload[0], payload[1]), int(payload[2])
            self._adopt_corr(step, mbi)
            self._on_grad(step, mbi, int(payload[5]), payload[6:])

    def _adopt_corr(self, step: int, mbi: int) -> None:
        """Bind the correlation id the envelope delivered (the thread's,
        set by ``ReliableTransport.recv``) to this (step, mb), so that the
        member's compute spans and onward ships carry the driver's id."""
        if self.recorder is None:
            return
        corr = current_corr()
        if corr and (step, mbi) not in self._mb_corr:
            self._mb_corr[(step, mbi)] = corr

    def _compute(self, t: int, mbi: Optional[int] = None) -> None:
        """The loop is computing (for microbatch ``mbi`` of step ``t``)."""
        if self._clock is not None:
            self._clock.set("compute",
                            corr=None if mbi is None else self._mb_corr.get((t, mbi), 0))

    def _on_ship(self, step: int, mbi: int, kind: int, cid: int, body: np.ndarray) -> None:
        if self.stage is None or not (0 <= mbi < self.M):
            return
        if step < self.step:
            self.stats["stale_dropped"] += 1
            return
        want = (self.mb_size * self.seq_len if kind in (SHIP_TOKENS, SHIP_TARGETS)
                else self.mb_size * self.seq_len * self.cfg.d_model)
        # decode before the size and finite gates, which judge the decoded
        # body; only SHIP_ACT may ride a lossy codec
        if kind != SHIP_ACT and cid != CODEC_DENSE:
            self.stats["malformed_dropped"] += 1
            return
        try:
            body = codecs.decode_body(MessageCode.ActivationShip, cid, body, want)
        except CompressionError:
            self.stats["malformed_dropped"] += 1
            return
        if not np.isfinite(body).all():
            self.stats["malformed_dropped"] += 1
            return
        if kind == SHIP_TARGETS:
            if not self.programs.last:
                return
            tgt = self._targets.setdefault(step, {})
            if mbi in tgt:
                self.stats["dup_inputs_dropped"] += 1
                return
            tgt[mbi] = body
            return
        if kind == SHIP_TOKENS and not self.programs.first:
            return
        if kind == SHIP_ACT and self.programs.first:
            return
        if kind not in (SHIP_TOKENS, SHIP_ACT):
            return
        if mbi in self._done_fwd.get(step, ()):
            self.stats["dup_inputs_dropped"] += 1
            return
        inp = self._inputs.setdefault(step, {})
        if mbi in inp:
            self.stats["dup_inputs_dropped"] += 1
            return
        inp[mbi] = body

    def _on_grad(self, step: int, mbi: int, cid: int, body: np.ndarray) -> None:
        if self.stage is None or self.programs.last or not (0 <= mbi < self.M):
            return
        try:
            body = codecs.decode_body(MessageCode.ActivationGrad, cid, body,
                                      self.mb_size * self.seq_len * self.cfg.d_model)
        except CompressionError:
            self.stats["malformed_dropped"] += 1
            return
        if not np.isfinite(body).all():
            self.stats["malformed_dropped"] += 1
            return
        if step < self.step:
            # a replay for a step already applied: stale (dup_grads_dropped
            # counts real double deliveries only)
            self.stats["stale_dropped"] += 1
            return
        if mbi in self._done_bwd.get(step, ()):
            self.stats["dup_grads_dropped"] += 1
            return
        gin = self._gin.setdefault(step, {})
        if mbi in gin:
            self.stats["dup_grads_dropped"] += 1
            return
        gin[mbi] = body

    # -------------------------------------------------------------- compute
    def _act(self, body: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(body.reshape(self.mb_size, self.seq_len,
                                             self.cfg.d_model)).to(self.device)

    def _ids(self, body: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.rint(body).astype(np.int64).reshape(
            self.mb_size, self.seq_len)).to(self.device)

    def _decode_input(self, body: np.ndarray) -> torch.Tensor:
        return self._ids(body) if self.programs.first else self._act(body)

    def _throttle_sleep(self) -> None:
        """Scripted slow compute (the straggler knob): busy time for the
        coordinator's straggler telemetry, spent serving the transport in
        slices so a throttled stage still acks its peers: slow, not dead."""
        t0 = time.perf_counter()
        deadline = t0 + self.throttle
        while not self._stop.is_set():
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            msg = self.transport.recv(timeout=min(0.02, left))
            if msg is not None:
                try:
                    self.handle(*msg)
                except (ValueError, IndexError, OverflowError):
                    pass
        self.stats["busy_s"] += time.perf_counter() - t0

    def _pump(self) -> None:
        """All the compute the buffered messages allow, for the CURRENT step
        only; traffic of later steps waits its turn.

        Nothing runs before the first placement: a hand-off computed while
        the member cannot route would be retained but never sent, and with
        the neighbour's incarnation unchanged no replay would ever re-ship
        it."""
        if self.stage is None or self._superseded or self._placement is None:
            return
        progressed = True
        while progressed and not self._stop.is_set():
            progressed = False
            t = self.step
            prog = self.programs
            done_f = self._done_fwd.setdefault(t, set())
            done_b = self._done_bwd.setdefault(t, set())
            inputs = self._inputs.setdefault(t, {})
            grads = self._mb_grads.setdefault(t, {})
            for mbi in range(self.M):
                if self._stop.is_set():
                    return
                if mbi in done_f or mbi not in inputs:
                    continue
                if prog.last:
                    tgt = self._targets.get(t, {}).get(mbi)
                    if tgt is None:
                        continue
                    self._compute(t, mbi)
                    t0 = time.perf_counter()
                    ce_sum, d_params, d_x = prog.loss_bwd(
                        self.params, self._decode_input(inputs[mbi]), self._ids(tgt))
                    ce_sum = float(ce_sum)
                    d_x = None if prog.first else d_x.cpu().numpy()
                    self.stats["busy_s"] += time.perf_counter() - t0
                    grads[mbi] = d_params
                    done_f.add(mbi)
                    done_b.add(mbi)
                    self.stats["fwd"] += 1
                    self.stats["bwd"] += 1
                    if d_x is not None:
                        self._ship("bwd", t, mbi, d_x)
                    self._ship("loss", t, mbi, np.asarray([ce_sum], np.float32))
                else:
                    self._compute(t, mbi)
                    t0 = time.perf_counter()
                    h_out = prog.fwd(self.params, self._decode_input(inputs[mbi])).cpu().numpy()
                    self.stats["busy_s"] += time.perf_counter() - t0
                    done_f.add(mbi)
                    self.stats["fwd"] += 1
                    self._ship("fwd", t, mbi, h_out)
                if self.throttle > 0:
                    self._throttle_sleep()
                progressed = True
            if not prog.last:
                gin = self._gin.setdefault(t, {})
                for mbi in range(self.M):
                    if self._stop.is_set():
                        return
                    if mbi in done_b or mbi not in done_f or mbi not in gin:
                        continue
                    self._compute(t, mbi)
                    t0 = time.perf_counter()
                    d_params, d_x = prog.bwd(self.params, self._decode_input(inputs[mbi]),
                                             self._act(gin[mbi]))
                    d_x = None if prog.first else d_x.cpu().numpy()
                    self.stats["busy_s"] += time.perf_counter() - t0
                    grads[mbi] = d_params
                    done_b.add(mbi)
                    self.stats["bwd"] += 1
                    if d_x is not None:
                        self._ship("bwd", t, mbi, d_x)
                    if self.throttle > 0:
                        self._throttle_sleep()
                    progressed = True
            if len(done_b) == self.M:
                self._apply_update(t)
                progressed = True

    def _apply_update(self, t: int) -> None:
        grads = self._mb_grads[t]
        acc = grads[0]
        for mbi in range(1, self.M):  # microbatch order: a deterministic sum
            acc = _add(acc, grads[mbi])
        self._compute(t)
        t0 = time.perf_counter()
        self.params, self.opt_state = self.programs.update(self.params, self.opt_state, acc)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["busy_s"] += time.perf_counter() - t0
        for mbi in range(self.M):
            self.applied_log.append((t, mbi))
        self.stats["updates"] += 1
        self.step = t + 1
        # straggler telemetry: this update's BUSY milliseconds, not wall time
        # (every stage shares the pipeline's wall cadence; only busy time
        # tells the coordinator which stage is slow)
        busy_ms = (self.stats["busy_s"] - self._busy_at_update) * 1e3
        self._busy_at_update = self.stats["busy_s"]
        self._ewma.update(busy_ms)
        if self.recorder is not None:
            self.recorder.event("update", corr=0, step=self.step, busy_ms=round(busy_ms, 3))
            # the retired steps' correlation ids are done with
            self._mb_corr = {k: v for k, v in self._mb_corr.items()
                             if k[0] >= self.step - self.retain_steps}
        for d in (self._inputs, self._targets, self._gin, self._mb_grads, self._done_fwd,
                  self._done_bwd):
            d.pop(t, None)
        floor = self.step - self.retain_steps
        for dirn in self._retained.values():
            for key in [k for k in dirn if k[0] < floor]:
                del dirn[key]
        self._save_ckpt()
        self.coord.report(self.watermark, self.step, self._ewma.value)
        if self.step_hook is not None:
            self.step_hook(self, self.step)

    # ---------------------------------------------------------- durability
    def _flat_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """The parameters flattened in ``state_dict`` order (the optimizer
        state is empty). On the card they come back through one pinned host
        buffer the member keeps: a pageable copy of a stage's 0.2 GB runs at
        about 1.3 GB/s there."""
        flat = torch.cat([t.detach().reshape(-1) for t in self.params.values()])
        if flat.is_cuda:
            if self._host_flat is None or self._host_flat.numel() != flat.numel():
                self._host_flat = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self._host_flat.copy_(flat)
            flat = self._host_flat
        return flat.numpy(), np.zeros(0, np.float32)

    def _save_ckpt(self) -> None:
        if not self.ckpt_dir or self._superseded:
            return
        if self._clock is not None:
            self._clock.set("ckpt")
        pflat, oflat = self._flat_state()
        save_stage_checkpoint(self.ckpt_dir, stage=self.stage, step=self.step,
                              watermark=self.watermark, lo=self.lo, hi=self.hi,
                              params_flat=pflat, opt_flat=oflat)
        # back to compute until the loop next classifies its wait
        self._compute(self.step)

    def restore(self, manifest=None) -> None:
        """Parameters, optimizer state and watermark from this stage's
        checkpoint. With a ``FleetManifest`` the checkpoint must cover the
        manifest's promise for this member: the same range and a watermark
        at or past the recorded apply seq. State BEHIND the promise is
        refused."""
        if self.stage is None or not self.ckpt_dir:
            raise ValueError("restore needs an assigned stage and ckpt_dir")
        meta, pflat, oflat = load_stage_checkpoint(self.ckpt_dir)
        if int(meta["stage"]) != self.stage:
            raise ValueError(f"checkpoint in {self.ckpt_dir} is for stage {meta['stage']}, "
                             f"this member serves {self.stage}")
        if manifest is not None:
            rec = manifest.entry_for(self.rank)
            if (rec.lo, rec.hi) != (self.lo, self.hi):
                from distributed_ml_pytorch_tpu_torch.coord.manifest import ManifestError

                raise ManifestError(f"manifest assigns rank {self.rank} range "
                                    f"[{rec.lo},{rec.hi}) but stage {self.stage} owns "
                                    f"[{self.lo},{self.hi})")
            if int(meta["watermark"]) < rec.apply_seq:
                raise ValueError(f"stage checkpoint watermark {meta['watermark']} is BEHIND "
                                 f"the manifest's promised apply seq {rec.apply_seq} — "
                                 "refusing to restore stale state")
        n = sum(t.numel() for t in self.params.values())
        if pflat.size != n or oflat.size != 0:
            raise ValueError(f"stage checkpoint holds {pflat.size} params and {oflat.size} "
                             f"optimizer floats, the stage wants {n} and 0")
        flat = torch.from_numpy(pflat)
        cursor = 0
        with torch.no_grad():
            for t in self.params.values():
                t.copy_(flat[cursor:cursor + t.numel()].reshape(t.shape))
                cursor += t.numel()
        self.opt_state = ()
        self.step = int(meta["step"])

    def _do_snapshot(self, snapshot_id: int, map_version: int) -> None:
        """The snapshot barrier: checkpoint NOW (the serve loop sits between
        computations) and report the range and watermark to the
        coordinator's ``FleetManifest``."""
        if self.stage is None or self._superseded:
            return
        self._save_ckpt()
        self.stats["snapshots"] += 1
        self.coord.snapshot_done(snapshot_id, map_version, self.lo, self.hi,
                                 apply_seq=self.watermark, push_count=self.step)

    # ---------------------------------------------------------- speculation
    def _apply_speculation(self, task_id: int, victim_rank: int, from_step: int) -> None:
        """A standby's side of a ``SpeculateTask``: take the victim's stage
        from its checkpoint and race it (the coordinator's placement flip is
        the first-wins dedup; the victim goes passive when it sees it)."""
        if self.stage is not None or not self.ckpt_root:
            return  # an assigned member only notes it; supersession does the rest
        p = self._placement
        entry = p.entry_for_rank(victim_rank) if p is not None else None
        if entry is None:
            return
        victim_stage = entry.stage
        self._install_stage(victim_stage)
        self.ckpt_dir = os.path.join(self.ckpt_root, f"stage{victim_stage}")
        try:
            self.restore()
        except ValueError:
            _LOGGER.warning("speculation: standby rank %d cannot read stage %d checkpoint — "
                            "staying idle", self.rank, victim_stage)
            self.stage = None
            self.params = None
            self.opt_state = None
            return
        _LOGGER.info("speculation task %d: standby rank %d adopted stage %d at watermark %d "
                     "(racing rank %d)", task_id, self.rank, victim_stage, self.watermark,
                     victim_rank)
        self.coord.stage_ready(self.stage, self.watermark)

    def _wait_state(self) -> str:
        """What the loop is about to wait on, once :meth:`_pump` found
        nothing to compute: missing inputs ``wait-act``; every forward done
        but cotangents missing ``wait-grad``; unassigned, superseded or
        before the first placement ``idle``."""
        if self.stage is None or self._superseded or self._placement is None:
            return "idle"
        t = self.step
        done_f = self._done_fwd.get(t, set())
        if len(done_f) >= self.M:
            return "idle" if self.programs.last else "wait-grad"
        if (self.programs is not None and not self.programs.last
                and len(self._done_bwd.get(t, set())) < len(done_f)):
            # forwards still owed and cotangents outstanding: the schedule
            # waits on the downstream neighbour first (the 1F1B drain)
            return "wait-grad"
        return "wait-act"

    # ------------------------------------------------------------ serve loop
    def run(self, timeout: Optional[float] = None) -> None:
        """Serve until :meth:`stop` or :meth:`crash` (or ``timeout``). An
        exception of the serve loop is kept in ``self.error`` and stops the
        member: a thread that died in silence would wedge the pipeline with
        no diagnosis. On the way out a recorder flushes its attribution,
        takes the wire's counters and, with ``obs_dir``, is dumped there
        (reason ``death``, ``error`` or ``stop``)."""
        try:
            self._run(timeout)
        except Exception as e:  # noqa: BLE001 — surfaced through self.error
            self.error = repr(e)
            _LOGGER.exception("stage %s member rank %d serve loop died", self.stage, self.rank)
            self._stop.set()
        finally:
            if self.recorder is not None:
                self._clock.flush()
                # the wire's counters join the ring before the dump
                emit = getattr(self.transport, "emit_wire_stats", None)
                if emit is not None:
                    emit()
                reason = ("error" if self.error is not None
                          else "death" if self._crashed else "stop")
                if self.obs_dir:
                    flight_dump(self.recorder, self.obs_dir, reason)

    def _run(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        self.coord.join(timeout=30)
        if self.stage is not None:
            self.coord.stage_ready(self.stage, self.watermark)
        last_announce = time.monotonic()
        while not self._stop.is_set():
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                break
            if self._clock is not None:
                self._clock.set(self._wait_state())
            msg = self.transport.recv(timeout=0.02)
            if msg is not None:
                try:
                    self.handle(*msg)
                except (ValueError, IndexError, OverflowError):
                    pass  # a malformed frame: drop it, never die
            self._drain_mailboxes()
            self._pump()
            if self.stage is not None and not self._superseded and now - last_announce > 1.0:
                # self-heal: re-announce while the placement does not name us
                # (a lost StageReady, or a lease that lapsed for a moment)
                p = self._placement
                e = (p.entries[self.stage] if p is not None and self.stage < len(p.entries)
                     else None)
                if e is None or e.rank != self.rank:
                    self.coord.stage_ready(self.stage, self.watermark)
                last_announce = now


# ---------------------------------------------------------------------- driver

class MpmdDriver:
    """The data feeder and loss collector of an MPMD fleet.

    It ships every step's microbatch tokens to stage 0 and targets to the
    last stage up front (``ActivationShip`` kinds 1 and 2: each channel's
    send sequence is then a function of the data alone, so the chaos layer
    can fault these channels with a byte-identical log), retains the bodies
    and re-ships them to restarted endpoints on an incarnation change. It
    folds the ``ce_sum`` reports into each step's mean loss. It mints each
    (step, mb)'s correlation id at its first ship (a re-ship reuses it), and
    with ``recorder`` and ``obs_dir`` dumps its ring there at the end of
    :meth:`run`."""

    def __init__(self, transport: Transport, coord, n_stages: int, n_microbatches: int,
                 recorder=None, obs_dir: Optional[str] = None):
        self.transport = transport
        self.coord = coord
        self.S = int(n_stages)
        self.M = int(n_microbatches)
        self._placement = None
        self._mu = threading.Lock()
        self._placement_mail = None
        if getattr(coord, "on_stage_assign", None) is None:
            coord.on_stage_assign = self._note_placement
        self._tokens: Dict[Tuple[int, int], np.ndarray] = {}
        self._targets: Dict[Tuple[int, int], np.ndarray] = {}
        self._ce: Dict[Tuple[int, int], float] = {}
        self.losses: List[float] = []
        self.step_times: List[float] = []
        self.stats = {"reshipped": 0, "dup_loss_dropped": 0, "send_failed": 0}
        #: how far behind the frontier the replay data and the correlation
        #: ids are kept: past the stages' own retain window
        self.retain_steps = 8
        self.recorder = recorder
        self.obs_dir = obs_dir
        self._mb_corr: Dict[Tuple[int, int], int] = {}

    def _note_placement(self, placement) -> None:
        with self._mu:
            if self._placement_mail is None or placement.version > self._placement_mail.version:
                self._placement_mail = placement

    def _rank_of_stage(self, stage: int) -> Optional[int]:
        p = self._placement
        if p is None:
            return None
        rank = p.entries[stage].rank
        return rank if rank >= 0 else None

    def _send(self, dst: int, step: int, mbi: int, kind: int, body: np.ndarray) -> None:
        ver = self._placement.version if self._placement is not None else 0
        # tokens and targets are exact by contract: the dense codec only
        cid, coded = codecs.encode_body(MessageCode.ActivationShip, body.ravel(), CODEC_DENSE)
        head = np.asarray([*_split16(step), float(mbi), float(kind), *_split16(ver),
                           float(cid)], np.float32)
        corr = self._mb_corr.get((step, mbi))
        if corr is None:
            corr = self._mb_corr[(step, mbi)] = next_corr()
        try:
            with corr_scope(corr):
                self.transport.send(MessageCode.ActivationShip, np.concatenate([head, coded]),
                                    dst=dst)
        except (OSError, ConnectionError, KeyError):
            self.stats["send_failed"] += 1

    def _retire_below(self, floor: int) -> None:
        """Drop the replay data of steps retired past the replay window: a
        restarted stage replays from its last checkpoint."""
        if floor <= 0:
            return
        for store in (self._tokens, self._targets, self._ce):
            for key in [k for k in store if k[0] < floor]:
                del store[key]
        self._mb_corr = {k: v for k, v in self._mb_corr.items() if k[0] >= floor}

    def _drain_placement(self) -> None:
        from distributed_ml_pytorch_tpu_torch.coord.stages import placement_deltas

        with self._mu:
            placement, self._placement_mail = self._placement_mail, None
        if placement is None:
            return
        old, self._placement = self._placement, placement
        # incarnation changes only: the driver never ships into a vacancy,
        # so a re-admission of the same life has nothing to replay (and a
        # needless re-ship would move the faulted channels' chaos log)
        for e in placement_deltas(old, placement, inc_only=True):
            if e.stage == 0:
                store, kind = self._tokens, SHIP_TOKENS
            elif e.stage == self.S - 1:
                store, kind = self._targets, SHIP_TARGETS
            else:
                continue
            for (step, mbi), body in sorted(store.items()):
                if step * self.M + mbi < e.watermark:
                    continue
                self._send(e.rank, step, mbi, kind, body)
                self.stats["reshipped"] += 1

    def wait_ready(self, timeout: float = 30.0) -> bool:
        """Block until a placement with every stage assigned arrives."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._drain_placement()
            p = self._placement
            if p is not None and all(e.rank >= 0 for e in p.entries):
                return True
            time.sleep(0.02)
        return False

    def run(self, tokens_steps, targets_steps, *, timeout: float = 180.0,
            step_hook: Optional[Callable[[int, float], None]] = None) -> List[float]:
        """Feed ``steps`` of ``(M, mb, seq)`` microbatches through the fleet;
        the per-step mean losses. ``TimeoutError`` if the fleet does not
        finish in time."""
        steps = len(tokens_steps)
        mb, seq = tokens_steps[0].shape[1], tokens_steps[0].shape[2]
        n_mask = mb * (seq - 1)
        self.coord.join(timeout=30)
        if not self.wait_ready():
            raise TimeoutError("driver: placement never fully assigned")
        first_rank = self._rank_of_stage(0)
        last_rank = self._rank_of_stage(self.S - 1)
        for t in range(steps):
            for mbi in range(self.M):
                tok = np.asarray(tokens_steps[t][mbi], np.float32).ravel()
                tgt = np.asarray(targets_steps[t][mbi], np.float32).ravel()
                self._tokens[(t, mbi)] = tok
                self._targets[(t, mbi)] = tgt
                self._send(first_rank, t, mbi, SHIP_TOKENS, tok)
                self._send(last_rank, t, mbi, SHIP_TARGETS, tgt)
        deadline = time.monotonic() + timeout
        next_step = 0
        while next_step < steps:
            if time.monotonic() >= deadline:
                raise TimeoutError(f"driver: step {next_step}/{steps} never completed "
                                   f"({len(self._ce)} ce reports held)")
            msg = self.transport.recv(timeout=0.05)
            self._drain_placement()
            if msg is not None:
                _sender, code, payload = msg
                if (code == MessageCode.ActivationShip and payload.size >= 8
                        and np.isfinite(payload[:7]).all() and int(payload[3]) == SHIP_LOSS
                        and int(payload[6]) == CODEC_DENSE):
                    step, mbi = _join16(payload[0], payload[1]), int(payload[2])
                    body = payload[7:]
                    if (step, mbi) in self._ce:
                        self.stats["dup_loss_dropped"] += 1
                    elif 0 <= step < steps and 0 <= mbi < self.M and np.isfinite(body[0]):
                        self._ce[(step, mbi)] = float(body[0])
            while next_step < steps and all((next_step, mbi) in self._ce
                                            for mbi in range(self.M)):
                ce = sum(self._ce[(next_step, mbi)] for mbi in range(self.M))
                loss = ce / float(n_mask * self.M)
                self.losses.append(loss)
                self.step_times.append(time.monotonic())
                if self.recorder is not None:
                    self.recorder.event("step-complete", corr=0, step=next_step,
                                        loss=round(float(loss), 6))
                if step_hook is not None:
                    step_hook(next_step, loss)
                next_step += 1
                self._retire_below(next_step - self.retain_steps)
        if self.recorder is not None and self.obs_dir:
            emit = getattr(self.transport, "emit_wire_stats", None)
            if emit is not None:
                emit()
            flight_dump(self.recorder, self.obs_dir, "stop")
        return self.losses
