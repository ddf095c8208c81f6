"""Sample from a Transformer LM — the port's inference-side example
(counterpart of the root ``examples/generate_text.py``).

``training/train_lm.py`` is the training entry into the LM API; this is its
decode counterpart: build (or restore) a ``TransformerLM`` and sample
continuations with the knobs of ``models/generate.py``:

    python -m distributed_ml_pytorch_tpu_torch.examples.generate_text --new-tokens 64
    python -m distributed_ml_pytorch_tpu_torch.examples.generate_text --temperature 0.8 \
        --top-k 50 --top-p 0.9
    python -m distributed_ml_pytorch_tpu_torch.examples.generate_text --kv-quant
    python -m distributed_ml_pytorch_tpu_torch.examples.generate_text --ckpt-dir runs/lm \
        --d-model 128 ...
    python -m distributed_ml_pytorch_tpu_torch.examples.generate_text --backend cpu

The flags are the root script's, with ``--backend`` (the card by default, or
the CPU). ``--ckpt-dir`` restores the parameters of the latest checkpoint
that ``training/train_lm.py --ckpt-dir`` wrote, as the serving CLI does (the
model flags must match the training run; ``train_lm`` uses ``max_len =
max(--seq, 256)``). Without it, sampling runs from a seeded fresh model:
useless text, but the whole decode path. ``--tp D`` decodes tensor-parallel
(``models/generate.generate_tp``) over a ``{"data": 1, "model": D}`` mesh:
a world of D threads with ``--backend cpu``, of D processes on the card
(``--dist-backend gloo`` when they share one card; NCCL refuses two ranks
on one device; each child finds its rank and rendezvous in ``RANK`` and
``MASTER_PORT``). Rank 0 prints.

Decode runs the ring-buffered block path for 17+ token runs (K8 in every
single-token step on the card); ``--kv-quant`` stores completed blocks as
int8 with per-key scales.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--prompt-len", type=int, default=32,
                   help="length of the random prompt (token ids)")
    p.add_argument("--new-tokens", type=int, default=64)
    p.add_argument("--batch", type=int, default=2,
                   help="number of prompts sampled in parallel")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 = categorical sampling")
    p.add_argument("--top-k", type=int, default=0,
                   help="keep only the k highest logits (0 = off)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus truncation mass (1.0 = off)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache: half the cache footprint, exact "
                        "prefill logits (models/generate.py)")
    p.add_argument("--tp", type=int, default=0, metavar="D",
                   help="tensor-parallel decode over D ranks (threads on the CPU, "
                        "processes on the card)")
    p.add_argument("--dist-backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="(--tp) torch.distributed backend: nccl (default on the card, "
                        "one rank per card) or gloo")
    p.add_argument("--ckpt-dir", type=str, default="",
                   help="restore params from a training/train_lm.py checkpoint")
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-ff", type=int, default=256)
    p.add_argument("--max-len", type=int, default=0,
                   help="learned-position table size (0 = derived from the "
                        "decode length). Restoring a train_lm.py checkpoint "
                        "with learned positions requires the TRAINING run's "
                        "table size: train_lm uses max(--seq, 256)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--pos-encoding", default="learned",
                   choices=["learned", "rope"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    return p


def _max_len(args) -> int:
    """The learned-position table: ``--max-len``, or room for the padded
    blocked decode."""
    return args.max_len or max(args.prompt_len + args.new_tokens + 16, 256)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.d_model % args.n_heads:
        parser.error(f"--d-model {args.d_model} must divide by --n-heads "
                     f"{args.n_heads}")
    if args.temperature <= 0.0 and (args.top_k or args.top_p < 1.0):
        parser.error("--top-k/--top-p need --temperature > 0 (greedy decode "
                     "ignores them)")
    if args.kv_quant:
        from types import SimpleNamespace

        from distributed_ml_pytorch_tpu_torch.models.generate import uses_block_decode

        shape = SimpleNamespace(pos_encoding=args.pos_encoding, max_len=_max_len(args))
        if not uses_block_decode(shape, args.prompt_len, args.new_tokens)[0]:
            parser.error(
                "--kv-quant only applies on the ring-buffered block path "
                "(>= 17 new tokens, prompt length > 1, <= 1025 new tokens, "
                "and the padded run must fit --max-len) — this shape would "
                "silently run the exact cache")
    if args.tp:
        for name, dim in (("n_heads", args.n_heads), ("d_ff", args.d_ff),
                          ("vocab", args.vocab)):
            if dim % args.tp:
                raise ValueError(f"--tp {args.tp}: --{name.replace('_', '-')} {dim} is not "
                                 f"divisible by the tp degree")
        return _main_tp(argv, args)
    _decode(args, None)
    return 0


def _main_tp(argv, args) -> int:
    """``--tp D``: a world of D threads (the CPU), the D processes it
    launches (the card), or one of them (``RANK`` set)."""
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import (
        init_distributed,
        make_mesh,
        run_threaded,
    )

    shape = {"data": 1, "model": args.tp}
    if args.backend == "cpu":
        run_threaded(args.tp, lambda w: _decode(args, make_mesh(shape, world=w)),
                     backend=args.dist_backend or "gloo", device="cpu")
        return 0
    if "RANK" not in os.environ:
        import subprocess

        from distributed_ml_pytorch_tpu_torch.launch import _free_port, _wait_all

        port = _free_port()
        cmd = [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.examples.generate_text",
               *(argv if argv is not None else sys.argv[1:])]
        return _wait_all([subprocess.Popen(cmd, env=dict(os.environ, RANK=str(r),
                                                         MASTER_PORT=port))
                          for r in range(args.tp)], 0.2)
    world = init_distributed(args.dist_backend, "localhost", os.environ["MASTER_PORT"],
                             args.tp, int(os.environ["RANK"]), device=args.backend)
    _decode(args, make_mesh(shape, world=world))
    return 0


def _decode(args, mesh) -> None:
    """Build (or restore) the model, decode the seeded prompt, print (rank 0
    of a mesh only)."""
    import torch

    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.models.generate import generate, generate_tp

    device = args.backend if mesh is None else mesh.device
    lm = TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
        # blocked decode pads the step loop to whole 16-token blocks; keep
        # the learned-position table large enough for the padded positions
        # (a restore must instead match the training run's table via
        # --max-len: the parameter shapes are part of the checkpoint)
        max_len=_max_len(args),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        pos_encoding=args.pos_encoding, seed=args.seed, device=device)
    if args.ckpt_dir:
        from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
            create_lm_train_state,
        )
        from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
        from distributed_ml_pytorch_tpu_torch.utils.checkpoint import Checkpointer

        with Checkpointer(args.ckpt_dir) as ckpt:
            if ckpt.latest_step() is None:
                raise SystemExit(
                    f"no checkpoint under {args.ckpt_dir} — train one with "
                    "training/train_lm.py --ckpt-dir first")
            _state, step = ckpt.restore(create_lm_train_state(lm, SGD(0.1)))
        print(f"restored params from step {step} of {args.ckpt_dir}")

    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, args.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    dev = next(lm.parameters()).device
    seed = args.seed + 1 if args.temperature > 0 else None
    t0 = time.perf_counter()
    if mesh is None:
        out = generate(lm, torch.from_numpy(prompt).to(dev), args.new_tokens,
                       temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                       seed=seed, kv_quant=args.kv_quant)
    else:
        out = generate_tp(lm, torch.from_numpy(prompt), args.new_tokens, mesh,
                          temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                          seed=seed, kv_quant=args.kv_quant)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0
    if mesh is not None and mesh.rank != 0:
        return
    mode = "int8 KV cache" if args.kv_quant else "bf16/f32 KV cache"
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tp = f", tensor-parallel over {mesh.size} ranks" if mesh is not None else ""
    print(f"decode ({mode}{tp}): {args.batch * args.new_tokens} tokens in {dt:.2f}s "
          f"(first call included) on {where}")
    for b in range(args.batch):
        print(f"[{b}] prompt : {' '.join(map(str, out[b, :args.prompt_len]))}")
        print(f"[{b}] sampled: {' '.join(map(str, out[b, args.prompt_len:]))}")


if __name__ == "__main__":
    raise SystemExit(main())
