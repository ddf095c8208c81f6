"""``train_lm``'s ported mesh modes as processes, and phase 27 of
``chip_smoke.py`` rehearsed on the CPU.

``--mode sp|ulysses|pp|moe|composite`` each run as two processes through
``launch.py --entry train_lm`` over gloo at test widths (all five at
once): each prints its mesh and one final loss, which is finite. Phase 27
(``chip_smoke.phase_parallel(torch, device="cpu", tiny=True)``) runs its
one-rank references, then the 2-process and the 4-process worlds, every
part within its gate (the plain versions stand in for the kernels on the
CPU, so no launch is counted). Its gradient gate fails each of four faults
patched into the rank processes (``bench_par_faults``), while their first
losses stay near the one-rank loss.
"""

import json
import math
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {
    "sp": "1x2 dp x seq (ring) on cpu",
    "ulysses": "1x2 dp x seq (all-to-all) on cpu",
    "pp": "2-stage GPipe, 4 microbatches on cpu",
    "moe": "1x2 dp x ep (4 experts) on cpu",
    "composite": "1x1x2 dp x fsdp x tp on cpu",
}


def test_train_lm_mesh_modes_run_as_processes(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = {}
    for mode in MODES:
        cwd = tmp_path / mode
        cwd.mkdir()
        procs[mode] = subprocess.Popen(
            [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.launch", "--world-size",
             "2", "--entry", "train_lm", "--", "--mode", mode, "--dist-backend", "gloo",
             "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "32", "--vocab",
             "64", "--d-model", "32", "--n-heads", "4", "--d-ff", "64"],
            cwd=str(cwd), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for mode, proc in procs.items():
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, (mode, out[-2000:] + err[-2000:])
        assert MODES[mode] in out, (mode, out)
        finals = re.findall(r"final loss ([0-9.]+)", out)
        assert len(finals) == 1 and math.isfinite(float(finals[0])), (mode, out)


def test_phase_parallel_rehearses_on_the_cpu(capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches, errors = cs.phase_parallel(torch, device="cpu", tiny=True)
    finally:
        torch.set_num_threads(prev)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"phase"')]
    assert [ln["phase"] for ln in lines] == [
        "parallel_references", "parallel_sp", "parallel_ulysses", "parallel_pp_gpipe",
        "parallel_pp_1f1b", "parallel_pp_dp", "parallel_moe", "parallel_composite",
        "parallel"]
    assert all(ln["ok"] for ln in lines) and not errors
    assert launches == dict.fromkeys(launches, 0)  # the plain versions on the CPU
    gpipe, f1b = lines[3]["per_rank"], lines[4]["per_rank"]
    assert [r["peak_stash"] for r in gpipe] == [2, 2]
    assert [r["peak_stash"] for r in f1b] == [2, 1]


def test_phase_parallel_gradient_gate_catches_each_fault(capsys):
    """A ring that sees future tokens, a reversed all-to-all, an expert
    combine and row-parallel outputs not summed over their axis: on every
    rank the first-step gradient is further than ``PAR_GRAD_RTOL`` from the
    one-rank step's (the sound runs of the rehearsal above read 0.007 at
    most), although a first loss may still sit within ``PAR_LOSS_RTOL``."""
    from distributed_ml_pytorch_tpu_torch import bench_par_faults

    assert bench_par_faults.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out["faults"]) == ["composite", "moe", "sp", "ulysses"]
    for part, rec in out["faults"].items():
        n = 2 if part in ("sp", "ulysses") else 4
        assert len(rec["per_rank"]) == n, (part, rec)
        for row in rec["per_rank"]:
            assert row["grad_rel_err"] > 3 * out["grad_rtol"], (part, row)
