"""Train the Transformer LM (counterpart of the JAX ``examples/train_lm.py``,
every ``--mode``).

    python -m distributed_ml_pytorch_tpu_torch.training.train_lm --steps 20
    python -m distributed_ml_pytorch_tpu_torch.training.train_lm --device cpu --steps 4
    python -m distributed_ml_pytorch_tpu_torch.training.train_lm --steps 8 \
        --steps-per-dispatch 4 --ckpt-dir runs/lm --ckpt-every 4 [--resume]

Builds a ``TransformerLM`` from the flags, draws one batch of synthetic
tokens from ``np.random.default_rng(--seed)`` (the same tokens as the JAX
script) and trains on it for ``--steps`` SGD steps, printing the loss at
five evenly spaced dispatches and the steady-state tokens/s (wall clock
over dispatches 1 .. N-1, so the first dispatch's kernel build and graph
capture are excluded). On the card float32 matmuls run in full float32,
not TF32 (``device.full_float32()``), as in the JAX reference's float32
configuration.

``--steps-per-dispatch K`` > 1 draws K more batches from the same
generator, after the first, and trains on all K in every dispatch
(``parallel/fsdp.make_fsdp_lm_scan_train_step``: on the card one step
captured as a CUDA graph and replayed K times, on the CPU a loop);
``--steps`` must divide by K. ``--ckpt-dir`` offers the state to a
``utils/checkpoint.Checkpointer`` (``save_interval_steps=--ckpt-every``)
after every dispatch, and saves the last step at the end; ``--resume``
restores the latest checkpoint there in place and trains ``--steps`` more.
The flags of ``--mode single`` keep their names and defaults; ``--device``
(``cuda`` by default, or ``cpu``) is new.

The mesh modes train on a world of ``--world-size`` processes (``launch.py
--entry train_lm``; ``--master``, ``--port``, ``--rank``,
``--dist-backend``), the mesh sized as the JAX script sizes it over its
devices:

- ``fsdp``: ``{"data": gcd(world, batch)}``;
- ``tp``: ``{"data": gcd(world / m, batch), "model": m}`` with ``m =
  gcd(world, n_heads, d_ff, vocab)``;
- ``sp`` (ring attention) and ``ulysses`` (all-to-all):
  ``{"data": gcd(world / q, batch), "seq": q}`` with ``q = gcd(world,
  seq)``, and for Ulysses also ``gcd(q, n_heads)``;
- ``pp`` (GPipe): ``{"data": --pp-dp, "stage": gcd(world / (dp·tp),
  n_layers), "model": --pp-tp}`` (the ``data``/``model`` axes only when
  wider than 1), ``gcd(--microbatches, batch)`` microbatches; the float32
  ``PipelineLMConfig`` of the flags' widths;
- ``moe`` (dp × ep): ``{"data": gcd(world / e, batch), "expert": e}`` with
  ``e = gcd(world, --n-experts)``, a ``MoETransformerLM``;
- ``composite`` (dp × fsdp × tp): ``model = gcd(2, n_heads, d_ff,
  vocab)`` (1 past the world), the rest ``gcd(world / model, batch)``
  split into ``data`` 2 (when even) and ``fsdp``.

The mesh must take the whole world. ``--batch`` is the global batch; each
rank trains on its share (``parallel/*.py``), and rank 0 prints. In a mesh
mode ``--ckpt-dir``/``--ckpt-every``/``--resume`` save and restore the
mode's global tree (``utils/checkpoint.ShardedCheckpointer``: gathered
over the mesh, written by rank 0, restored into the full model before the
mode shards it, so that it lands in the mode's layout); a checkpoint of
another mode raises. The chunked loss is ported for single and fsdp only.
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

MODES = ["single", "sp", "ulysses", "fsdp", "tp", "pp", "moe", "composite"]
MESH_MODES = ("sp", "ulysses", "fsdp", "tp", "pp", "moe", "composite")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", default="single", choices=MODES,
                   help="parallelism mode")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--loss-chunk", type=int, default=0, metavar="C",
                   help="compute the LM loss in C-token sequence chunks without "
                        "materializing the full (batch, seq, vocab) logits; 0 = dense loss")
    p.add_argument("--steps-per-dispatch", type=int, default=1, metavar="K",
                   help="K steps (K distinct batches) a dispatch: on the card one step "
                        "captured as a CUDA graph and replayed; --steps must divide by K")
    p.add_argument("--ckpt-dir", type=str, default="",
                   help="checkpoint under this directory")
    p.add_argument("--ckpt-every", type=int, default=100,
                   help="save every N global steps")
    p.add_argument("--resume", action="store_true", default=False,
                   help="restore the latest checkpoint from --ckpt-dir")
    p.add_argument("--batch", type=int, default=8, help="batch (sequences)")
    p.add_argument("--seq", type=int, default=256, help="sequence length")
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-ff", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--pos-encoding", default="learned", choices=["learned", "rope"])
    p.add_argument("--remat", action="store_true",
                   help="per-block rematerialization (long sequences)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    p.add_argument("--n-experts", type=int, default=4,
                   help="(--mode moe) experts per MoE layer")
    p.add_argument("--microbatches", type=int, default=4,
                   help="(--mode pp) GPipe microbatches per step")
    p.add_argument("--pp-dp", type=int, default=1, metavar="D",
                   help="(--mode pp) data-parallel pipeline replicas on a "
                        "(data=D, stage) mesh — dp x pp composition")
    p.add_argument("--pp-tp", type=int, default=1, metavar="T",
                   help="(--mode pp) tensor-parallel width INSIDE each pipeline stage "
                        "(Megatron block sharding over a model axis); composes with "
                        "--pp-dp for the full dp x pp x tp 3-D layout")
    p.add_argument("--world-size", type=int, default=1,
                   help="(mesh modes) ranks in the world")
    p.add_argument("--rank", type=int, default=0, help="(mesh modes) this process's rank")
    p.add_argument("--master", type=str, default="localhost",
                   help="(mesh modes) host of rank 0's rendezvous")
    p.add_argument("--port", type=str, default="29500",
                   help="(mesh modes) port of rank 0's rendezvous")
    p.add_argument("--dist-backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="(mesh modes) nccl (default on the card, one rank per card) or gloo")
    return p


def mesh_shape(args: argparse.Namespace) -> dict:
    """The mesh of a mesh ``--mode`` over ``--world-size`` ranks (the JAX
    script's sizing over its devices; see the module docstring)."""
    n = args.world_size
    if args.mode == "fsdp":
        return {"data": math.gcd(n, args.batch)}
    if args.mode in ("sp", "ulysses"):
        q = math.gcd(n, args.seq)
        if args.mode == "ulysses":
            q = math.gcd(q, args.n_heads)
        return {"data": math.gcd(n // q, args.batch), "seq": q}
    if args.mode == "pp":
        dp, tp = args.pp_dp, args.pp_tp
        shape = {"data": dp} if dp > 1 else {}
        shape["stage"] = math.gcd(n // (dp * tp), args.n_layers)
        if tp > 1:
            shape["model"] = tp
        return shape
    if args.mode == "moe":
        e = math.gcd(n, args.n_experts)
        return {"data": math.gcd(n // e, args.batch), "expert": e}
    if args.mode == "composite":
        m = math.gcd(2, math.gcd(args.n_heads, math.gcd(args.d_ff, args.vocab)))
        if m > n:
            m = 1
        combined = math.gcd(n // m, args.batch)
        d = 2 if combined % 2 == 0 and combined > 1 else 1
        return {"data": d, "fsdp": combined // d, "model": m}
    m = math.gcd(math.gcd(n, args.n_heads), math.gcd(args.d_ff, args.vocab))
    return {"data": math.gcd(n // m, args.batch), "model": m}


def _check_pp(parser, args) -> None:
    """``--mode pp``'s flag errors, the JAX script's."""
    d_pp, d_tp, n = args.pp_dp, args.pp_tp, args.world_size
    if d_pp < 1:
        parser.error(f"--pp-dp must be >= 1, got {d_pp}")
    if d_tp < 1:
        parser.error(f"--pp-tp must be >= 1, got {d_tp}")
    if n % (d_pp * d_tp):
        parser.error(f"--pp-dp {d_pp} x --pp-tp {d_tp} must divide the device count {n}")
    if args.n_heads % d_tp or args.d_ff % d_tp:
        parser.error(f"--pp-tp {d_tp} must divide n_heads {args.n_heads} and d_ff "
                     f"{args.d_ff}")
    n_mb = math.gcd(args.microbatches, args.batch)
    if d_pp > 1 and (args.batch // n_mb) % d_pp:
        parser.error(f"--pp-dp {d_pp} must divide the per-microbatch batch "
                     f"{args.batch // n_mb}")


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, checked; a bad or unported combination exits with an error."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode == "pp":
        _check_pp(parser, args)
    if args.mode in MESH_MODES:
        shape = mesh_shape(args)
        if math.prod(shape.values()) != args.world_size:
            why = ""
            if args.mode == "ulysses" and math.gcd(args.world_size, args.n_heads) == 1:
                why = (f" (Ulysses shards heads over the seq axis: n_heads={args.n_heads} "
                       f"is not divisible by any share of it)")
            parser.error(f"--mode {args.mode}: the mesh {shape} the flags allow does not "
                         f"take the whole world of {args.world_size} ranks{why}")
        if args.mode != "fsdp" and args.loss_chunk:
            parser.error(f"--mode {args.mode}: the chunked loss is ported for single and "
                         f"fsdp only (drop --loss-chunk)")
    if args.steps < 1:
        parser.error("--steps must be >= 1")
    k = args.steps_per_dispatch
    if k < 1:
        parser.error("--steps-per-dispatch must be >= 1")
    if args.steps % k:
        parser.error(f"--steps {args.steps} must divide by --steps-per-dispatch {k}")
    if args.resume and not args.ckpt_dir:
        parser.error("--resume requires --ckpt-dir")
    if args.ckpt_every < 1:
        parser.error("--ckpt-every must be >= 1")
    if args.d_model % args.n_heads:
        parser.error(
            f"--d-model {args.d_model} must be divisible by --n-heads "
            f"{args.n_heads} (attention splits d_model into heads)"
        )
    if args.loss_chunk and args.seq % args.loss_chunk:
        parser.error(f"--seq {args.seq} must divide by --loss-chunk {args.loss_chunk}")
    return args


@dataclass
class LMRun:
    """What a run leaves: the trained state, the step function and the
    batches it took (``[K, B, S]`` stacks for K > 1), every step's loss, the
    steady-state rate (0.0 for a one-dispatch run) and the step it resumed
    from (0 for a fresh run)."""

    state: object
    step_fn: object
    tokens: torch.Tensor
    targets: torch.Tensor
    losses: List[float] = field(default_factory=list)
    tokens_per_s: float = 0.0
    steady_s: float = 0.0
    start_step: int = 0


def lm_batches(args: argparse.Namespace):
    """``(tokens, targets)`` int32 as the JAX script draws them: one
    ``(batch, seq)`` batch from ``default_rng(--seed)``, and for K > 1 the
    K batches drawn after it, stacked ``(K, batch, seq)``."""
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import next_token_targets

    rng = np.random.default_rng(args.seed)
    shape = (args.batch, args.seq)
    tokens = rng.integers(0, args.vocab, size=shape).astype(np.int32)
    if args.steps_per_dispatch == 1:
        return tokens, next_token_targets(tokens)
    ks = [rng.integers(0, args.vocab, size=shape).astype(np.int32)
          for _ in range(args.steps_per_dispatch)]
    return np.stack(ks), np.stack([next_token_targets(t) for t in ks])


def build_model(args: argparse.Namespace, device):
    """The flags' seeded ``TransformerLM`` on ``device``."""
    from distributed_ml_pytorch_tpu_torch.models import TransformerLM

    return TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=max(args.seq, 256),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        pos_encoding=args.pos_encoding, remat=args.remat, seed=args.seed, device=device,
    )


def _mesh_setup(args, tx, dev, attn_fn=None, mesh=None, load_full=None):
    """``(mesh, state, step, shard, desc, layout)`` of a mesh ``--mode``:
    this process's rank of the world builds the mode's model from the seed
    on ``dev`` (``attn_fn`` injected into every block), ``load_full(model)``
    (a checkpoint's global tree) loads it before the mode shards it, and
    builds the step over its share of a global batch (``shard(tokens,
    targets)``); ``step`` returns ``(state, loss)``, ``layout(state)`` is the
    state's checkpoint layout (``utils/checkpoint``)."""
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import current_world, make_mesh
    from distributed_ml_pytorch_tpu_torch.utils.checkpoint import replicated_layout

    mesh = mesh or make_mesh(mesh_shape(args), current_world())
    shape = mesh.shape
    dims = "x".join(str(v) for v in shape.values())
    if args.mode == "pp":
        from distributed_ml_pytorch_tpu_torch.parallel.pipeline import (
            PipelineLM,
            PipelineLMConfig,
            create_pp_train_state,
            make_pp_train_step,
            microbatch,
            pp_layout,
        )

        cfg = PipelineLMConfig(vocab_size=args.vocab, d_model=args.d_model,
                               n_heads=args.n_heads, n_layers=args.n_layers, d_ff=args.d_ff,
                               max_len=max(args.seq, 256))
        n_mb = math.gcd(args.microbatches, args.batch)
        data_axis = "data" if "data" in shape else None
        model_axis = "model" if "model" in shape else None
        params = None
        if load_full is not None:
            with torch.device("meta"):
                full = PipelineLM(cfg)
            load_full(full)
            params = full.state_dict()
        state = create_pp_train_state(cfg, tx, mesh, model_axis=model_axis, seed=args.seed,
                                      params=params)
        if attn_fn is not None:
            for blk in state.model.blocks:
                blk.attn.attn_fn = attn_fn
        step = make_pp_train_step(cfg, tx, mesh, n_mb, data_axis=data_axis,
                                  model_axis=model_axis)
        tp_desc = f" x {args.pp_tp} tp-in-stage" if model_axis else ""
        desc = (f"{dims} dp x pp GPipe{tp_desc}, {n_mb} microbatches" if data_axis else
                f"{shape['stage']}-stage GPipe{tp_desc}, {n_mb} microbatches")
        return (mesh, state, step, lambda t, g: microbatch(t, g, n_mb), desc,
                lambda st: pp_layout(st, model_axis=model_axis))
    if args.mode == "moe":
        from distributed_ml_pytorch_tpu_torch.models.moe import MoETransformerLM
        from distributed_ml_pytorch_tpu_torch.parallel.expert_parallel import (
            create_ep_train_state,
            ep_layout,
            make_ep_train_step,
            shard_ep_batch,
        )

        lm = MoETransformerLM(
            vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
            n_layers=args.n_layers, d_ff=args.d_ff, n_experts=args.n_experts,
            max_len=max(args.seq, 256),
            dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
            remat=args.remat, seed=args.seed, device=dev)
        if attn_fn is not None:
            lm.set_attn_fn(attn_fn)
        if load_full is not None:
            load_full(lm)
        state = create_ep_train_state(lm, tx, mesh)
        ep_step = make_ep_train_step(lm, tx, mesh)

        def step(state, tokens, targets):
            state, (loss, _aux) = ep_step(state, tokens, targets)
            return state, loss

        return (mesh, state, step, lambda t, g: shard_ep_batch(mesh, t, g),
                f"{dims} dp x ep ({args.n_experts} experts)", ep_layout)
    lm = build_model(args, dev)
    if attn_fn is not None:
        lm.set_attn_fn(attn_fn)
    if load_full is not None:
        load_full(lm)
    if args.mode in ("sp", "ulysses"):
        from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
            create_lm_train_state,
            make_sp_train_step,
            shard_lm_batch,
        )
        from distributed_ml_pytorch_tpu_torch.parallel.ulysses import make_ulysses_train_step

        state = create_lm_train_state(lm, tx)
        make = make_sp_train_step if args.mode == "sp" else make_ulysses_train_step
        pattern = "ring" if args.mode == "sp" else "all-to-all"
        return (mesh, state, make(lm, tx, mesh), lambda t, g: shard_lm_batch(mesh, t, g),
                f"{dims} dp x seq ({pattern})", replicated_layout)
    if args.mode == "composite":
        from distributed_ml_pytorch_tpu_torch.parallel.composite import (
            composite_layout,
            create_composite_train_state,
            make_composite_train_step,
            shard_composite_batch,
        )

        state, specs = create_composite_train_state(lm, tx, mesh)
        return (mesh, state, make_composite_train_step(lm, tx, mesh, specs),
                lambda t, g: shard_composite_batch(mesh, t, g), f"{dims} dp x fsdp x tp",
                lambda st: composite_layout(st, specs))
    if args.mode == "fsdp":
        from distributed_ml_pytorch_tpu_torch.parallel.fsdp import (
            create_fsdp_train_state,
            fsdp_layout,
            make_fsdp_lm_train_step,
            param_shard_fraction,
            shard_fsdp_batch,
        )

        state = create_fsdp_train_state(lm, tx, mesh)
        step = make_fsdp_lm_train_step(lm, tx, mesh, loss_chunk=args.loss_chunk)
        desc = f"{mesh.size}-way fsdp ({param_shard_fraction(state):.3f} of params/rank)"
        return mesh, state, step, lambda t, g: shard_fsdp_batch(mesh, t, g), desc, fsdp_layout
    from distributed_ml_pytorch_tpu_torch.parallel.tensor_parallel import (
        create_tp_train_state,
        make_tp_train_step,
        shard_tp_batch,
        tp_layout,
    )

    state = create_tp_train_state(lm, tx, mesh)
    step = make_tp_train_step(lm, tx, mesh)
    return (mesh, state, step, lambda t, g: shard_tp_batch(mesh, t, g),
            f"{shape['data']}x{shape['model']} dp x tp", tp_layout)


def _k_steps(step):
    """K mesh steps a dispatch: the per-step body on each of K stacked
    batches (a loop: a CUDA graph cannot capture a gloo collective)."""

    def scan(state, tokens, targets):
        losses = []
        for i in range(tokens.shape[0]):
            state, loss = step(state, tokens[i], targets[i])
            losses.append(loss.reshape(()))
        return state, torch.stack(losses)

    return scan


def run(args: argparse.Namespace, attn_fn=None) -> LMRun:
    """Build, train and report as :func:`main` does; returns the run.
    ``attn_fn`` is injected into every block (``None``: the model's
    default attention). A mesh ``--mode`` needs this process in a world
    (:func:`main` joins it; ``runtime.mesh.run_threaded`` for a world of
    threads)."""
    from distributed_ml_pytorch_tpu_torch.device import full_float32, resolve_device
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import (
        make_fsdp_lm_scan_train_step,
        make_fsdp_lm_train_step,
    )
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import create_lm_train_state
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import current_world
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    world = current_world() if args.mode in MESH_MODES else None
    if args.mode in MESH_MODES and world is None:
        raise ValueError(f"--mode {args.mode} runs in a world: call main() or join one first")
    dev = world.device if world is not None else resolve_device(args.device)
    if dev.type == "cuda":
        full_float32()
    tx = SGD(args.lr)
    k = args.steps_per_dispatch
    tokens, targets = lm_batches(args)
    mesh = None
    ckpt, start_step = None, 0
    if world is not None:
        from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh
        from distributed_ml_pytorch_tpu_torch.utils.checkpoint import ShardedCheckpointer

        mesh = make_mesh(mesh_shape(args), world)
        found = None
        if args.ckpt_dir:
            # its layout is the placed state's, set below
            ckpt = ShardedCheckpointer(args.ckpt_dir, mode=args.mode, mesh=mesh,
                                       layout_fn=None, save_interval_steps=args.ckpt_every)
            found = ckpt.load() if args.resume else None
        load_full = None if found is None else (lambda m: ckpt.restore_params(found[0], m))
        mesh, state, step1, shard, desc, layout_fn = _mesh_setup(args, tx, dev, attn_fn, mesh,
                                                                 load_full)
        if ckpt is not None:
            ckpt.layout_fn = layout_fn
        if found is not None:
            ckpt.restore_placed(state, found[0])
            start_step = found[1]
            if mesh.rank == 0:
                print(f"resumed from checkpoint step {start_step}", flush=True)
        step = _k_steps(step1) if k > 1 else step1
        tok, tgt = (torch.from_numpy(a.astype(np.int64)) for a in (tokens, targets))
        if k > 1:  # each of the K stacked batches sharded as one batch is
            pairs = [shard(tok[i], tgt[i]) for i in range(k)]
            tok, tgt = (torch.stack([torch.as_tensor(p[j]) for p in pairs]) for j in (0, 1))
        else:
            tok, tgt = shard(tok, tgt)
        where = f"{desc} on {dev.type}"
    else:
        lm = build_model(args, dev)
        if attn_fn is not None:
            lm.set_attn_fn(attn_fn)
        state = create_lm_train_state(lm, tx)
        if k > 1:
            step = make_fsdp_lm_scan_train_step(lm, tx, k, loss_chunk=args.loss_chunk)
        else:
            step = make_fsdp_lm_train_step(lm, tx, loss_chunk=args.loss_chunk)
        tok = torch.from_numpy(tokens.astype(np.int64)).to(dev)
        tgt = torch.from_numpy(targets.astype(np.int64)).to(dev)
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
        where = f"single-device on {dev.type}, 1 of {n_dev} devices"
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    if args.ckpt_dir and mesh is None:
        from distributed_ml_pytorch_tpu_torch.utils.checkpoint import (
            Checkpointer,
            maybe_restore,
        )

        ckpt = Checkpointer(args.ckpt_dir, save_interval_steps=args.ckpt_every)
        if args.resume:
            state, start_step = maybe_restore(ckpt, state)
            if start_step:
                print(f"resumed from checkpoint step {start_step}", flush=True)

    say(f"training {args.n_layers}-layer LM ({where})", flush=True)
    n_disp = args.steps // k
    losses = []
    t0 = time.perf_counter()
    for i in range(n_disp):
        state, loss = step(state, tok, tgt)
        losses.append(loss.reshape(-1))
        if i == 0:
            float(loss.reshape(-1)[-1])  # wait for the first dispatch (build, capture)
            t0 = time.perf_counter()
        if ckpt is not None:
            ckpt.save(start_step + (i + 1) * k, state)
        if i % max(1, n_disp // 5) == 0:
            say(f"  step {i * k:4d}  loss {float(loss.reshape(-1)[-1]):.4f}", flush=True)
    final = float(losses[-1][-1])
    dt = time.perf_counter() - t0
    rate = (n_disp - 1) * k * args.batch * args.seq / dt if n_disp > 1 else 0.0
    say(f"final loss {final:.4f}; ~{rate:.0f} tokens/s "
        f"(naive wall-clock over dispatches 1..{n_disp - 1})", flush=True)
    if ckpt is not None:
        ckpt.save(start_step + args.steps, state, force=True)
        ckpt.close()
    return LMRun(state, step, tok, tgt, torch.cat(losses).float().tolist(), rate,
                 dt if n_disp > 1 else 0.0, start_step)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mode in MESH_MODES:
        from distributed_ml_pytorch_tpu_torch.runtime.mesh import init_distributed

        init_distributed(args.dist_backend, args.master, args.port, args.world_size,
                         args.rank, device=args.device)
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
