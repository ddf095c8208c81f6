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
useless text, but the whole decode path. ``--tp`` (tensor-parallel decode,
``generate_tp``) needs a device mesh, which this package does not have yet
(ROADMAP Queue A 7): it raises ``ValueError``.

Decode runs the ring-buffered block path for 17+ token runs (K8 in every
single-token step on the card); ``--kv-quant`` stores completed blocks as
int8 with per-key scales.
"""

from __future__ import annotations

import argparse
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
                   help="tensor-parallel decode over D devices (needs the device "
                        "mesh: refused in this package)")
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


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.d_model % args.n_heads:
        parser.error(f"--d-model {args.d_model} must divide by --n-heads "
                     f"{args.n_heads}")
    if args.temperature <= 0.0 and (args.top_k or args.top_p < 1.0):
        parser.error("--top-k/--top-p need --temperature > 0 (greedy decode "
                     "ignores them)")
    if args.tp:
        raise ValueError(
            "--tp: tensor-parallel decode (generate_tp) needs the device mesh, which "
            "this package does not port yet (ROADMAP Queue A 7) — drop --tp")

    import torch

    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.models.generate import generate, uses_block_decode

    total = args.prompt_len + args.new_tokens
    lm = TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
        # blocked decode pads the step loop to whole 16-token blocks; keep
        # the learned-position table large enough for the padded positions
        # (a restore must instead match the training run's table via
        # --max-len: the parameter shapes are part of the checkpoint)
        max_len=args.max_len or max(total + 16, 256),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        pos_encoding=args.pos_encoding, seed=args.seed, device=args.backend)
    if args.kv_quant:
        blocked, _ = uses_block_decode(lm, args.prompt_len, args.new_tokens)
        if not blocked:
            parser.error(
                "--kv-quant only applies on the ring-buffered block path "
                "(>= 17 new tokens, prompt length > 1, <= 1025 new tokens, "
                "and the padded run must fit --max-len) — this shape would "
                "silently run the exact cache")
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
    t0 = time.perf_counter()
    out = generate(lm, torch.from_numpy(prompt).to(dev), args.new_tokens,
                   temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                   seed=args.seed + 1 if args.temperature > 0 else None,
                   kv_quant=args.kv_quant)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0
    mode = "int8 KV cache" if args.kv_quant else "bf16/f32 KV cache"
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"decode ({mode}): {args.batch * args.new_tokens} tokens in {dt:.2f}s "
          f"(first call included) on {where}")
    for b in range(args.batch):
        print(f"[{b}] prompt : {' '.join(map(str, out[b, :args.prompt_len]))}")
        print(f"[{b}] sampled: {' '.join(map(str, out[b, args.prompt_len:]))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
