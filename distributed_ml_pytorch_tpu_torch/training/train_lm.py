"""Train the Transformer LM on one device (counterpart of the JAX
``examples/train_lm.py --mode single``).

    python -m distributed_ml_pytorch_tpu_torch.training.train_lm --steps 20
    python -m distributed_ml_pytorch_tpu_torch.training.train_lm --device cpu --steps 4

Builds a ``TransformerLM`` from the flags, draws one batch of synthetic
tokens from ``np.random.default_rng(--seed)`` (the same tokens as the JAX
script) and trains on it for ``--steps`` SGD steps, printing the loss at
five evenly spaced steps and the steady-state tokens/s (wall clock over
steps 1 .. N-1, so the first step's kernel build is excluded). On the card
float32 matmuls run in full float32, not TF32 (``device.full_float32()``),
as in the JAX reference's float32 configuration. The flags of
``--mode single`` keep their names and defaults; ``--device`` (``cuda`` by
default, or ``cpu``) is new. The other modes, ``--steps-per-dispatch`` > 1
and checkpointing (``--ckpt-dir``) are not ported yet and exit with an
error.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

MODES = ["single", "sp", "ulysses", "fsdp", "tp", "pp", "moe", "composite"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", default="single", choices=MODES,
                   help="parallelism mode; only 'single' is ported")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--loss-chunk", type=int, default=0, metavar="C",
                   help="compute the LM loss in C-token sequence chunks without "
                        "materializing the full (batch, seq, vocab) logits; 0 = dense loss")
    p.add_argument("--steps-per-dispatch", type=int, default=1, metavar="K",
                   help="(not ported yet: only 1)")
    p.add_argument("--ckpt-dir", type=str, default="",
                   help="(not ported yet: checkpointing)")
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
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, checked; a bad or unported combination exits with an error."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode != "single":
        parser.error(f"--mode {args.mode} is not ported yet (only --mode single)")
    if args.steps_per_dispatch != 1:
        parser.error("--steps-per-dispatch > 1 is not ported yet")
    if args.ckpt_dir:
        parser.error("--ckpt-dir (checkpointing) is not ported yet")
    if args.steps < 1:
        parser.error("--steps must be >= 1")
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
    """What a run leaves: the trained state, every step's loss and the
    steady-state rate (0.0 for a one-step run)."""

    state: object
    step_fn: object
    tokens: torch.Tensor
    targets: torch.Tensor
    losses: List[float] = field(default_factory=list)
    tokens_per_s: float = 0.0
    steady_s: float = 0.0


def run(args: argparse.Namespace) -> LMRun:
    """Build, train and report as :func:`main` does; returns the run."""
    from distributed_ml_pytorch_tpu_torch.device import full_float32, resolve_device
    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
        create_lm_train_state,
        next_token_targets,
    )
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        full_float32()
    lm = TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=max(args.seq, 256),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        pos_encoding=args.pos_encoding, remat=args.remat, seed=args.seed, device=dev,
    )
    tx = SGD(args.lr)
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, args.vocab, size=(args.batch, args.seq)).astype(np.int32)
    targets = next_token_targets(tokens)
    state = create_lm_train_state(lm, tx)
    step = make_fsdp_lm_train_step(lm, tx, loss_chunk=args.loss_chunk)
    tok = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    tgt = torch.from_numpy(targets.astype(np.int64)).to(dev)

    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"training {args.n_layers}-layer LM (single-device on {dev.type}, "
          f"1 of {n_dev} devices)", flush=True)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        state, loss = step(state, tok, tgt)
        losses.append(loss)
        if i == 0:
            float(loss)  # wait for the first step (kernel build included)
            t0 = time.perf_counter()
        if i % max(1, args.steps // 5) == 0:
            print(f"  step {i:4d}  loss {float(loss):.4f}", flush=True)
    final = float(losses[-1])
    dt = time.perf_counter() - t0
    rate = (args.steps - 1) * args.batch * args.seq / dt if args.steps > 1 else 0.0
    print(f"final loss {final:.4f}; ~{rate:.0f} tokens/s "
          f"(naive wall-clock over steps 1..{args.steps - 1})", flush=True)
    return LMRun(state, step, tok, tgt, [float(x) for x in losses], rate,
                 dt if args.steps > 1 else 0.0)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
