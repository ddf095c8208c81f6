"""``chip_smoke.py`` phase 27's gradient gate read on faulty runs: how far
the first step's ``PAR_GRAD_PARAM`` gradient and the first loss move when
the layers compute the wrong thing.

    python -m distributed_ml_pytorch_tpu_torch.bench_par_faults [--device cpu]

Runs phase 27's one-rank references, then its 2-process and 4-process
worlds (``chip_smoke.par_child``) with four faults patched in at run time
in each rank process (the package's files are not touched):

- ``sp``: a ring that attends to future tokens (``causal=False``);
- ``ulysses``: an all-to-all whose received chunks come back in reverse
  rank order;
- ``moe``: an expert combine not summed over ``expert``;
- ``composite``: row-parallel outputs not summed over ``model``.

Prints one JSON object: for each part and rank the first loss, its
relative distance from the one-rank loss and the gradient's
``‖g - g_ref‖ / ‖g_ref‖``, the readings ``PAR_GRAD_RTOL`` is set between.
``--device cpu`` rehearses it at the tiny widths. Run from the repository's
root (it imports ``chip_smoke``).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def faulty_child(rank: int, n: int, port: str, out_path: str, device: str,
                 tiny: bool) -> None:
    """``chip_smoke.par_child`` with the four faults patched in."""
    import torch

    from distributed_ml_pytorch_tpu_torch.parallel import expert_parallel as ep
    from distributed_ml_pytorch_tpu_torch.parallel import ring
    from distributed_ml_pytorch_tpu_torch.parallel import seq_parallel as sp
    from distributed_ml_pytorch_tpu_torch.parallel import tensor_parallel as tp
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import DeviceMesh

    sp._bind_ring = lambda model, mesh, axis: functools.partial(
        ring.ring_attention, mesh=mesh, axis=axis, causal=False)
    all_to_all = DeviceMesh.all_to_all

    def reversed_all_to_all(self, t, axis, split_dim, concat_dim):
        out = all_to_all(self, t, axis, split_dim, concat_dim)
        return torch.cat(out.chunk(self.axis_size(axis), dim=concat_dim)[::-1],
                         dim=concat_dim).contiguous()

    class NoSum:
        @staticmethod
        def apply(x, *args):
            return x

    DeviceMesh.all_to_all = reversed_all_to_all
    ep._ReduceFromModel = NoSum
    tp._ReduceFromModel = NoSum
    _chip_smoke().par_child(rank, n, port, out_path, device, tiny)


def _world(n: int, device: str, tiny: bool, tmp: str):
    from distributed_ml_pytorch_tpu_torch.launch import _free_port

    port = _free_port()
    paths = [os.path.join(tmp, f"faulty{n}_rank{r}.json") for r in range(n)]
    code = ("import sys; from distributed_ml_pytorch_tpu_torch import bench_par_faults as b; "
            "b.faulty_child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], "
            "sys.argv[5], sys.argv[6] == '1')")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(n), port, paths[r],
                               device, "1" if tiny else "0"], cwd=ROOT) for r in range(n)]
    try:
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise SystemExit(f"the faulty {n}-rank world exited with {codes}")
    out = []
    for path in paths:
        with open(path) as fh:
            out.append(json.load(fh))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch

    cs = _chip_smoke()
    tiny = args.device == "cpu"
    if args.device == "cuda":
        from distributed_ml_pytorch_tpu_torch.device import full_float32

        full_float32()
    ref = cs._par_references(torch, args.device, tiny)
    out = {"card": cs._card(torch, args.device), "grad_param": cs.PAR_GRAD_PARAM,
           "grad_rtol": cs.PAR_GRAD_RTOL, "faults": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for n, parts in ((cs.PAR_RANKS, (("sp", "lm"), ("ulysses", "lm"))),
                         (cs.PAR_WIDE, (("moe", "moe"), ("composite", "lm")))):
            ranks = _world(n, args.device, tiny, tmp)
            for part, key in parts:
                want = ref["lm"] if key == "lm" else ref["moe"][0]
                rows = [{"rank": r, "first_loss": rank[part]["losses"][0],
                         "loss_rel_err": abs(rank[part]["losses"][0] - want) / want,
                         "grad_rel_err": cs._grad_rel_err(rank[part]["grad"],
                                                          rank[part]["grad_offset"],
                                                          ref[key + "_grad"])}
                        for r, rank in enumerate(ranks)]
                out["faults"][part] = {"one_rank_first_loss": want, "per_rank": rows}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
