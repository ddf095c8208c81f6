"""Pipeline-parallel LM training: GPipe, 1F1B and interleaved (virtual-stage)
microbatch schedules over a ``stage`` mesh axis (counterpart of the JAX
``parallel/pipeline.py``).

The JAX package writes each schedule as one differentiated ``lax.scan``
inside ``shard_map``. Here every rank of the ``stage`` axis is a process
(or a thread) that holds its ``L/S`` contiguous layers as an
``nn.ModuleList`` and walks its own list of forward and backward units, in
the order the schedule's timetable gives it:

- **GPipe**: forwards at ticks ``s + m``, then the backwards in reverse
  microbatch order, ``(M+S-1) + (S-1-s) + (M-1-m)``; every stage keeps the
  autograd graphs of all ``M`` microbatches;
- **1F1B**: :func:`oneF1B_tick_roles`, the one timetable (kept as the JAX
  function, evaluable on host ints): warm-up forwards, then a backward after
  each forward; a stage keeps at most ``S`` graphs (``PipelineState.
  peak_stash`` records it). The backward of a microbatch is explicit:
  ``torch.autograd.backward`` on its stashed stage output with the
  cotangent received from the next stage (the loss seeds the last);
- **interleaved** (``virtual_stages=v``): each stage holds ``v`` strided
  chunks of layers (storage permuted by :func:`interleave_layer_order`);
  chunk ``r`` of microbatch ``m`` runs on stage ``s`` at tick ``r·M + m +
  s``. The ring wrap (stage ``S-1`` to stage 0 between rounds) waits
  ``M - S`` ticks on stage 0 (the wrap FIFO); the backwards run in the
  reverse order of the forwards.

The three schedules compute the same function: the masked next-token CE
summed over all ``M`` microbatches over the global count of unmasked
tokens (the final position of each sequence is masked).

Stage 0 applies the embeddings and the last stage ``ln_f``, the head and
the loss. Activations go forward and cotangents come back through
``DeviceMesh.send``/``recv`` on lanes of their own (one process group each
for the hand-off to the next stage, the ring wrap, and the two ways back,
so that under NCCL a send never waits behind a receive the other way).
Sends are posted as soon as a unit ends and waited on at the end of the
step; receives wait. Every rank computes the whole timetable, so the
sends and receives pair up.

**Gradients.** Each block's gradient stays on its stage. The embeddings,
``ln_f`` and the head are replicated on every stage but used on one, so
their gradients are summed over ``stage`` (JAX gets this from the
transpose of ``shard_map``). Under ``data_axis`` (dp × pp) each data row
runs the whole schedule on its rows of every microbatch; the row losses
take the mean over ``data`` and the gradients are averaged over it.

**pp × tp** (``model_axis``): each stage's blocks are the explicit
Megatron block (``tensor_parallel.shard_tp_block``: q/k/v and ``Dense_0``
column-parallel, ``o`` and ``Dense_1`` row-parallel, two sums over
``model`` a layer, no q/k/v bias), attention on the ``n_heads/tp`` local
heads. Activations stay model-invariant at every hand-off, so the
schedules do not change; each model rank of a stage exchanges with the
same model rank of its neighbours. The embeddings, ``ln_f`` and the head
stay replicated over ``model``.

The JAX config has no dtype: the path is float32, and on the card K4/K5
take ``csrc/attention.cu``'s float32 route.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.models.transformer import (
    Block,
    Dense,
    Embed,
    LayerNorm,
    init_flax_default_,
)
from distributed_ml_pytorch_tpu_torch.runtime.mesh import DeviceMesh, flat_all_reduce
from distributed_ml_pytorch_tpu_torch.training.trainer import TrainState, _apply

SCHEDULES = ("gpipe", "1f1b", "interleaved")
#: the replicated (non-block) modules, used on one stage each
REPLICATED = ("tok_embed", "pos_embed", "ln_f", "head")


class PipelineLMConfig:
    """Static config of the pipelined decoder LM (a plain data holder)."""

    def __init__(self, vocab_size: int = 64, d_model: int = 32, n_heads: int = 4,
                 n_layers: int = 4, d_ff: int = 64, max_len: int = 1024):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.d_ff = d_ff
        self.max_len = max_len

    def block(self) -> Block:
        return Block(self.d_model, self.n_heads, self.d_ff)


class PipelineLM(nn.Module):
    """The pipelined LM's parameters: ``tok_embed``, ``pos_embed``, the
    ``blocks`` (a ``ModuleList`` in storage order: the whole model, or one
    stage's layers), ``ln_f`` and the ``head`` (no bias), as the JAX tree
    names them. ``init_pp_params`` draws them from a seed (flax's default
    distributions, not its bits; parity tests carry weights across with
    ``utils/interop.pp_params_from_jax``)."""

    def __init__(self, cfg: PipelineLMConfig, n_blocks: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model)
        self.pos_embed = Embed(cfg.max_len, cfg.d_model)
        n = cfg.n_layers if n_blocks is None else n_blocks
        self.blocks = nn.ModuleList([cfg.block() for _ in range(n)])
        self.ln_f = LayerNorm(cfg.d_model)
        self.head = Dense(cfg.d_model, cfg.vocab_size, bias=False)


def init_pp_params(cfg: PipelineLMConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The whole pipelined model's ``state_dict`` (all ``n_layers`` blocks
    in model order) from ``seed``, on the host."""
    return init_flax_default_(PipelineLM(cfg), seed).state_dict()


def interleave_layer_order(n_layers: int, n_stages: int, v: int) -> np.ndarray:
    """The layer permutation that hands each stage its ``v`` strided
    virtual-stage chunks under contiguous stage sharding: chunk ``V = r·S +
    s`` (round r, stage s) is stored at position ``(V mod S)·v + V//S``;
    ``blocks[order]`` is the schedule-ready layout."""
    chunk_len = n_layers // (n_stages * v)
    order = []
    for s in range(n_stages):
        for r in range(v):
            V = r * n_stages + s
            order.extend(range(V * chunk_len, (V + 1) * chunk_len))
    return np.asarray(order)


def permute_blocks(state_dict: Dict[str, torch.Tensor], order: Sequence[int]
                   ) -> Dict[str, torch.Tensor]:
    """``state_dict`` with block ``order[i]`` stored as block ``i`` (the
    JAX ``blocks[order]`` of the stacked tree)."""
    out = {}
    for name, t in state_dict.items():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            out[f"blocks.{list(order).index(int(i))}.{rest}"] = t
        else:
            out[name] = t
    return out


def pp_param_specs(tree, stage_axis: str = "stage", model_axis: Optional[str] = None
                   ) -> Dict[str, Tuple]:
    """``{name: spec}`` over a mapping of the pipelined model's parameter
    names to tensors or shapes: a block leaf's spec is its stacked layout's, the
    layer axis first, then the port's ``(out, in)`` dims; every other leaf
    is replicated, ``()``. With ``model_axis`` (pp × tp) the block leaves
    also carry the Megatron sharding within their stage shard:

    ==========================  ============================
    block leaf                  spec
    ==========================  ============================
    ``attn.{q,k,v}.weight``     ``(stage, model, None)``
    ``attn.o.weight``           ``(stage, None, model)``
    ``Dense_0.weight``          ``(stage, model, None)``
    ``Dense_0.bias``            ``(stage, model)``
    ``Dense_1.weight``          ``(stage, None, model)``
    ``Dense_1.bias``, the LNs   ``(stage, None)``
    ==========================  ============================
    """
    out = {}
    for name, leaf in tree.items():
        parts = name.split(".")
        if parts[0] != "blocks":
            out[name] = ()
            continue
        ndim = len(tuple(getattr(leaf, "shape", leaf)))
        spec = [None] * ndim
        if model_axis is not None:
            if "attn" in parts and parts[-2] in ("q", "k", "v"):
                spec[0] = model_axis
            elif "attn" in parts and parts[-2] == "o":
                spec[1] = model_axis
            elif "Dense_0" in parts:
                spec[0] = model_axis
            elif "Dense_1" in parts and ndim == 2:
                spec[1] = model_axis
        out[name] = (stage_axis, *spec)
    return out


def _check_tp_divisibility(cfg: PipelineLMConfig, n_model: int) -> None:
    for name, dim in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff)):
        if dim % n_model:
            raise ValueError(
                f"cfg.{name}={dim} is not divisible by the tp axis size "
                f"{n_model} — the sharded dimension must split evenly")


def _check_layers(cfg: PipelineLMConfig, n_stages: int) -> None:
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers={cfg.n_layers} must divide evenly over {n_stages} stages")


class PipelineState(TrainState):
    """A ``TrainState`` whose model is this rank's stage (a
    :class:`PipelineLM` holding its ``L/S`` blocks), with the stage's index
    and, after a step, the most microbatch graphs it kept at once
    (``peak_stash``)."""

    def __init__(self, model, opt_state, stage: int, n_stages: int, step: int = 0):
        super().__init__(model, opt_state, step)
        self.stage, self.n_stages = stage, n_stages
        self.peak_stash = 0


def create_pp_train_state(cfg: PipelineLMConfig, tx, mesh: DeviceMesh,
                          stage_axis: str = "stage", model_axis: Optional[str] = None, *,
                          seed: int = 0,
                          params: Optional[Dict[str, torch.Tensor]] = None) -> PipelineState:
    """This rank's stage: the layers ``[s·L/S, (s+1)·L/S)`` of the whole
    model's ``params`` (a :func:`init_pp_params` ``state_dict``, from
    ``seed`` when ``None``; permute it with :func:`permute_blocks` for the
    interleaved schedule), the replicated modules, and, with
    ``model_axis``, the blocks Megatron-sharded within the stage; ``tx``'s
    state mirrors the local parameters."""
    S = mesh.axis_size(stage_axis)
    _check_layers(cfg, S)
    if model_axis is not None:
        _check_tp_divisibility(cfg, mesh.axis_size(model_axis))
    full = params if params is not None else init_pp_params(cfg, seed)
    s = mesh.axis_index(stage_axis)
    per = cfg.n_layers // S
    local = {}
    for name, t in full.items():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            if s * per <= int(i) < (s + 1) * per:
                local[f"blocks.{int(i) - s * per}.{rest}"] = t.detach().clone()
        else:
            local[name] = t.detach().clone()
    with torch.device("meta"):
        model = PipelineLM(cfg, n_blocks=per)
    model.load_state_dict(local, assign=True)
    model.to(mesh.device)
    if model_axis is not None:
        from distributed_ml_pytorch_tpu_torch.parallel.tensor_parallel import shard_tp_block

        for blk in model.blocks:
            shard_tp_block(blk, mesh, model_axis)
    return PipelineState(model, tx.init(list(model.parameters())), s, S)


def pp_layout(state: PipelineState, stage_axis: str = "stage",
              model_axis: Optional[str] = None):
    """The checkpoint layout of a :func:`create_pp_train_state` state
    (``utils/checkpoint``): local block ``i`` is global block ``stage·L/S +
    i`` (``blocks``), Megatron-chunked within the stage with ``model_axis``
    (:func:`pp_param_specs`); the other leaves are replicated."""
    params = dict(state.model.named_parameters())
    per = len(state.model.blocks)
    specs = pp_param_specs(params, stage_axis, model_axis)
    out = []
    for name, p in params.items():
        ops = []
        if name.startswith("blocks."):
            ops.append(("blocks", stage_axis, per))
            dims = specs[name][1:]
            if model_axis is not None and model_axis in dims:
                ops.append(("split", model_axis, dims.index(model_axis)))
        out.append((name, p, tuple(ops)))
    return out


# ------------------------------------------------------------------ the timetables


def oneF1B_tick_roles(t, s, S: int, M: int):
    """The 1F1B timetable, the one copy: at tick ``t`` stage ``s`` runs the
    forward of microbatch ``m_f`` and/or the backward of ``m_b`` (at most
    one; -1 is idle). Warm-up forwards ``F(s, m) = s + m`` for ``m < S -
    s``; steady forwards ``F(s, m) = 2m + s``; backwards ``B(s, m) = 2S - 1
    - s + 2m``. Backward cotangents arrive one tick after their producer
    (``B(s, m) = B(s+1, m) + 1``); forward activations at ``F(s-1, m) + 1 <=
    F(s, m)``. Total ticks ``2(M + S - 1)``. Branch-free boolean arithmetic,
    as the JAX function (which traced values also call)."""
    warm = t - s
    is_warm = (t >= s) & (warm < S - s) & (warm < M)
    steady = warm // 2
    is_steady = (warm % 2 == 0) & (t >= s) & (steady >= S - s) & (steady < M)
    do_f = is_warm | is_steady
    m_f = is_warm * warm + is_steady * steady + (do_f - 1)
    tb = t - (2 * S - 1 - s)
    do_b = (tb >= 0) & (tb % 2 == 0) & (tb // 2 < M)
    m_b = do_b * (tb // 2) + (do_b - 1)
    return m_f, m_b


def stage_timetable(schedule: str, s: int, S: int, M: int, v: int = 1
                    ) -> List[Tuple[int, str, int, int]]:
    """Stage ``s``'s units in the order it runs them: ``(tick, "F" or "B",
    round r, microbatch m)`` (``r`` is 0 except under the interleaved
    schedule)."""
    out = []
    if schedule == "gpipe":
        for m in range(M):
            out.append((s + m, "F", 0, m))
            out.append(((M + S - 1) + (S - 1 - s) + (M - 1 - m), "B", 0, m))
    elif schedule == "1f1b":
        for t in range(2 * (M + S - 1)):
            m_f, m_b = oneF1B_tick_roles(t, s, S, M)
            if m_f >= 0:
                out.append((t, "F", 0, int(m_f)))
            if m_b >= 0:
                out.append((t, "B", 0, int(m_b)))
    elif schedule == "interleaved":
        T = v * M + S - 1
        for q in range(v * M):
            r, m = divmod(q, M)
            t = q + s
            out.append((t, "F", r, m))
            out.append((T + (T - 1 - t), "B", r, m))
    else:
        raise ValueError(
            f"schedule must be 'gpipe', '1f1b' or 'interleaved', got {schedule!r}")
    return sorted(out)


# ------------------------------------------------------------------ the step


def microbatch(tokens, targets, n_microbatches: int):
    """Split a ``(batch, seq)`` pair into ``(M, batch/M, seq)``."""
    b = tokens.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} must divide into {n_microbatches} microbatches")
    shape = (n_microbatches, b // n_microbatches) + tuple(tokens.shape[1:])
    return tokens.reshape(shape), targets.reshape(shape)


class _Links:
    """Point-to-point traffic of one step along the ``stage`` axis: a lane
    per direction, sends posted at once and waited at :meth:`finish`. The
    interleaved schedule adds the round-wrap lanes (last stage to first,
    and its cotangents back)."""

    def __init__(self, mesh: DeviceMesh, axis: str, wrap: bool):
        self.mesh, self.axis = mesh, axis
        self.me = mesh.axis_index(axis)
        self.pending = []
        lanes = ("next", "prev") + (("wrap", "unwrap") if wrap else ())
        #: hand-offs to this stage itself (one stage, interleaved), per lane
        self.local: Dict[str, List[torch.Tensor]] = {lane: [] for lane in lanes}
        for lane in lanes:
            mesh.lane(axis, lane)  # every rank makes every lane, in order

    def send(self, t, dst: int, lane: str):
        if dst == self.me:
            self.local[lane].append(t.detach().clone())
        else:
            self.pending.append(self.mesh.send(t.detach(), dst, self.axis, lane))

    def recv(self, like, src: int, lane: str):
        if src == self.me:
            return self.local[lane].pop(0)
        return self.mesh.recv(like, src, self.axis, lane)

    def finish(self):
        for work, _buf in self.pending:
            work.wait()
        self.pending = []


def make_pp_train_step(cfg: PipelineLMConfig, tx, mesh: DeviceMesh, n_microbatches: int,
                       stage_axis: str = "stage", schedule: str = "gpipe",
                       virtual_stages: int = 1, data_axis: Optional[str] = None,
                       model_axis: Optional[str] = None) -> Callable:
    """The pipelined LM step: ``step(state, tokens_mb, targets_mb) ->
    (state, loss)`` over global ``(M, mb, seq)`` microbatches (every rank
    passes the same; under ``data_axis`` each data row takes its rows of
    every microbatch). ``loss`` is the global masked mean (a device
    tensor). ``schedule``: ``"gpipe"``, ``"1f1b"`` or ``"interleaved"``
    (with ``virtual_stages=v > 1``, the state's blocks stored in
    :func:`interleave_layer_order`; needs ``M >= S`` and ``n_layers %
    (S·v) == 0``). The state comes from :func:`create_pp_train_state` with
    the same ``model_axis``."""
    S = mesh.axis_size(stage_axis)
    _check_layers(cfg, S)
    M = int(n_microbatches)
    if data_axis is not None and data_axis not in mesh.names:
        raise ValueError(f"data_axis {data_axis!r} is not in the mesh "
                         f"(axes: {mesh.shape})")
    if model_axis is not None:
        if model_axis not in mesh.names:
            raise ValueError(f"model_axis {model_axis!r} is not in the mesh "
                             f"(axes: {mesh.shape})")
        _check_tp_divisibility(cfg, mesh.axis_size(model_axis))
    v = 1
    if schedule == "interleaved":
        v = int(virtual_stages)
        if cfg.n_layers % (S * v):
            raise ValueError(f"n_layers={cfg.n_layers} must divide over {S} stages x {v} "
                             "virtual chunks")
        if M < S:
            raise ValueError(
                f"interleaved schedule needs n_microbatches >= n_stages "
                f"({M} < {S}): the round-wrap activation would be consumed "
                "before it is produced")
    elif schedule not in SCHEDULES:
        raise ValueError(
            f"schedule must be 'gpipe', '1f1b' or 'interleaved', got {schedule!r}")
    s = mesh.axis_index(stage_axis)
    events = stage_timetable(schedule, s, S, M, v)
    chunk_len = cfg.n_layers // (S * v)
    links = _Links(mesh, stage_axis, wrap=schedule == "interleaved")
    n_data = mesh.axis_size(data_axis) if data_axis is not None else 1

    def step(state: PipelineState, tokens_mb, targets_mb):
        model = state.model
        model.train()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        tok, tgt = (torch.as_tensor(np.asarray(a)).long() for a in (tokens_mb, targets_mb))
        if data_axis is not None:
            from distributed_ml_pytorch_tpu_torch.runtime.mesh import rows_of

            rows = rows_of(tok.shape[1], mesh, data_axis)
            tok, tgt = tok[:, rows], tgt[:, rows]
        tok, tgt = tok.to(mesh.device), tgt.to(mesh.device)
        mb, seq = tok.shape[1], tok.shape[2]
        like = torch.empty((mb, seq, cfg.d_model), dtype=torch.float32, device=mesh.device)
        positions = torch.arange(seq, device=mesh.device)[None, :]
        inv_total = 1.0 / (M * mb * (seq - 1))
        mask = torch.ones((mb, seq), dtype=torch.float32, device=mesh.device)
        mask[:, -1] = 0.0
        loss_sum = torch.zeros((), dtype=torch.float32, device=mesh.device)
        stash: Dict[Tuple[int, int], Tuple] = {}
        peak = 0

        def last(r):
            return s == S - 1 and r == v - 1

        for _t, kind, r, m in events:
            if kind == "F":
                if s == 0 and r == 0:
                    h_in = model.tok_embed(tok[m]) + model.pos_embed(positions)
                    leaf = None
                else:
                    src, lane = ((s - 1, "next") if s > 0 else (S - 1, "wrap"))
                    leaf = links.recv(like, src, lane).requires_grad_()
                    h_in = leaf
                h = h_in
                for blk in model.blocks[r * chunk_len:(r + 1) * chunk_len]:
                    h = blk(h)
                if last(r):
                    logits = model.head(model.ln_f(h))
                    ce = F.cross_entropy(logits.reshape(mb * seq, -1), tgt[m].reshape(-1),
                                         reduction="none")
                    out = torch.sum(ce * mask.reshape(-1))
                    loss_sum = loss_sum + out.detach()
                else:
                    out = h
                    if s < S - 1:
                        links.send(h, s + 1, "next")
                    else:
                        links.send(h, 0, "wrap")
                stash[(r, m)] = (leaf, out)
                peak = max(peak, len(stash))
            else:
                leaf, out = stash.pop((r, m))
                if last(r):
                    torch.autograd.backward(out * inv_total)
                else:
                    src, lane = ((s + 1, "prev") if s < S - 1 else (0, "unwrap"))
                    g = links.recv(like, src, lane)
                    torch.autograd.backward(out, g)
                if leaf is not None:
                    if s > 0:
                        links.send(leaf.grad, s - 1, "prev")
                    else:
                        links.send(leaf.grad, S - 1, "unwrap")
        links.finish()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        names = [n for n, _ in model.named_parameters()]
        with torch.no_grad():
            rep = [j for j, n in enumerate(names) if n.split(".")[0] in REPLICATED]
            for j, g in zip(rep, flat_all_reduce(mesh, [grads[j] for j in rep], stage_axis)):
                grads[j] = g
            loss = mesh.all_reduce(loss_sum.reshape(1), stage_axis)[0] * inv_total
            if data_axis is not None:
                grads = [g / n_data for g in flat_all_reduce(mesh, grads, data_axis)]
                loss = mesh.all_reduce(loss.reshape(1), data_axis)[0] / n_data
        for p in params:
            p.grad = None
        _apply(tx, state.opt_state, params, grads)
        state.step += 1
        state.peak_stash = peak
        return state, loss

    return step
