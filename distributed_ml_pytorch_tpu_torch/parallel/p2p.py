"""Point-to-point tensor exchange over the mesh (counterpart of the JAX
``parallel/p2p.py``).

The reference demo (``pytorch_p2p_ex.py``) spawns two processes and moves a
one-element tensor from rank 0 to rank 1 with blocking ``dist.send`` /
``dist.recv`` over gloo. Here each rank holds its shard of an axis, and
:func:`p2p_send_recv` moves shards along ``pairs`` with the mesh's
``permute`` (every send and receive posted before any is waited on, the
``lax.ppermute`` of the JAX package).

    python -m distributed_ml_pytorch_tpu_torch.parallel.p2p [--device cpu]

runs the demo on a two-rank world of threads (on the card by default):
rank 1 ends up holding rank 0's value, and every rank prints what it has.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_ml_pytorch_tpu_torch.runtime.mesh import DeviceMesh, make_mesh, run_threaded


def p2p_send_recv(x: torch.Tensor, mesh: DeviceMesh, pairs: Sequence[Tuple[int, int]],
                  axis: str = "data", fill: str = "zeros") -> torch.Tensor:
    """This rank's shard after moving shards along ``pairs`` ``[(src, dst),
    ...]`` (indices along ``axis``). ``fill`` says what a rank that is no
    destination holds: ``"zeros"`` (the ppermute semantics) or ``"keep"``
    (its own shard: torch's, where ``send`` leaves the source intact)."""
    if fill not in ("zeros", "keep"):
        raise ValueError(f"fill must be 'zeros' or 'keep', got {fill!r}")
    out = mesh.permute(x, list(pairs), axis)
    if fill == "keep" and mesh.axis_index(axis) not in [d for _, d in pairs]:
        return x.clone()
    return out


def p2p_shift(x: torch.Tensor, mesh: DeviceMesh, shift: int = 1, axis: str = "data"
              ) -> torch.Tensor:
    """Ring shift: rank i's shard moves to rank (i + shift) mod n (the
    building block of ring schedules)."""
    n = mesh.axis_size(axis)
    return p2p_send_recv(x, mesh, [(i, (i + shift) % n) for i in range(n)], axis)


def demo_rank(mesh: DeviceMesh) -> List[float]:
    """One rank of the demo: rank 0 holds 1.0, the others 0.0; rank 0 sends
    to rank 1 (``fill="keep"``: rank 0 keeps its 1.0, as torch's ``send``
    does). Returns every rank's value (an ``all_gather``)."""
    x = torch.full((1,), 1.0 if mesh.axis_index("data") == 0 else 0.0, device=mesh.device)
    out = p2p_send_recv(x, mesh, [(0, 1)], fill="keep")
    return mesh.all_gather(out, "data").cpu().tolist()


def run_demo(n_ranks: int = 2, device="cuda", mesh: Optional[DeviceMesh] = None) -> np.ndarray:
    """The reference demo: with ``mesh``, this rank's part of it (it prints
    its own line); without, a world of ``n_ranks`` threads on ``device``
    (the lines printed in rank order). Returns every rank's value."""
    if mesh is not None:
        vals = demo_rank(mesh)
        print("Rank ", mesh.rank, " has data ", vals[mesh.rank], flush=True)
        return np.asarray(vals)
    vals = run_threaded(n_ranks, lambda w: demo_rank(make_mesh(world=w)), device=device)[0]
    for rank in range(n_ranks):
        print("Rank ", rank, " has data ", vals[rank], flush=True)
    return np.asarray(vals)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the reference's two-rank p2p demo")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ranks", type=int, default=2)
    args = p.parse_args(argv)
    run_demo(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
