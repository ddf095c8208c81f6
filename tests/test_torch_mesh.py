"""The port's device mesh (``runtime/mesh.py``) on worlds of threads.

- ranks lie row-major on the axes, as the JAX mesh lays out its devices
  (rank ``2·d + m`` of ``{"data": 2, "model": 2}`` holds the device at
  ``(d, m)`` of the JAX mesh), and each axis' group holds the ranks that
  share the other coordinates;
- the collectives (sum and max reductions, gather, reduce-scatter,
  broadcast, permute) give exact values;
- the backend is explicit: ``nccl`` with more ranks than cards, an unknown
  backend and a mesh that does not take the whole world raise
  ``ValueError``;
- no module of the port calls a collective on the default process group,
  and a world of threads never creates one.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh as jmake_mesh
from distributed_ml_pytorch_tpu_torch.runtime import mesh as rmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "distributed_ml_pytorch_tpu_torch")


def _world(n, fn, shape=None):
    return rmesh.run_threaded(n, lambda w: fn(rmesh.make_mesh(shape, world=w)))


def test_ranks_lie_row_major_as_the_jax_mesh():
    jmesh = jmake_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    want = {int(dev.id): (d, m) for (d, m), dev in np.ndenumerate(jmesh.devices)}
    coords = _world(4, lambda mesh: (mesh.coords["data"], mesh.coords["model"]),
                    {"data": 2, "model": 2})
    assert {r: c for r, c in enumerate(coords)} == want


def test_axis_groups_reduce_over_their_slice():
    def fn(mesh):
        t = torch.tensor([float(mesh.rank)])
        over_model = mesh.all_reduce(t.clone(), "model")
        over_data = mesh.all_reduce(t.clone(), "data")
        biggest = mesh.all_reduce(t.clone(), "data", op="max")
        return float(over_model), float(over_data), float(biggest)

    out = _world(4, fn, {"data": 2, "model": 2})
    # model pairs: (0, 1), (2, 3); data pairs: (0, 2), (1, 3)
    assert out == [(1.0, 2.0, 2.0), (1.0, 4.0, 3.0), (5.0, 2.0, 2.0), (5.0, 4.0, 3.0)]


def test_gather_scatter_broadcast_permute_are_exact():
    def fn(mesh):
        r = mesh.rank
        gathered = mesh.all_gather(torch.full((2, 3), float(r)), "data")
        scattered = mesh.reduce_scatter(torch.arange(8.0).reshape(4, 2) + r, "data")
        shared = mesh.broadcast(torch.full((3,), float(r)), "data", src=2)
        ring = mesh.permute(torch.tensor([float(r)]), [(i, (i + 1) % 4) for i in range(4)],
                            "data")
        return gathered, scattered, shared, ring, mesh.host_staged

    out = _world(4, fn)
    for r, (gathered, scattered, shared, ring, staged) in enumerate(out):
        assert torch.equal(gathered, torch.arange(4.0).repeat_interleave(2)[:, None]
                           .expand(8, 3))
        full = sum(torch.arange(8.0).reshape(4, 2) + k for k in range(4))
        assert torch.equal(scattered, full[r:r + 1])
        assert torch.equal(shared, torch.full((3,), 2.0))
        assert float(ring) == float((r - 1) % 4)
        assert staged == 0  # gloo takes CPU tensors as they are


def test_rank_and_size_are_the_threads_own():
    out = rmesh.run_threaded(3, lambda w: (rmesh.process_rank(), rmesh.world_size()))
    assert out == [(0, 3), (1, 3), (2, 3)]
    assert (rmesh.process_rank(), rmesh.world_size()) == (0, 1)


def test_backend_is_explicit():
    with pytest.raises(ValueError, match="refuses two ranks on one device"):
        rmesh.check_backend("nccl", 2, "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        rmesh.check_backend("mpi", 1, "cpu")
    with pytest.raises(ValueError, match="needs device='cuda'"):
        rmesh.check_backend("nccl", 1, "cpu")
    assert rmesh.default_backend("cuda") == "nccl"
    assert rmesh.default_backend("cpu") == "gloo"


def test_mesh_must_take_the_whole_world():
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 2"):
        rmesh.run_threaded(2, lambda w: rmesh.make_mesh({"data": 2, "model": 2}, world=w))
    with pytest.raises(ValueError, match="no world"):
        rmesh.make_mesh({"data": 1})


def test_no_collective_touches_the_default_group():
    """Every collective names its group: no ``dist.<collective>(...)`` call
    in the package, and a threaded world leaves the default group
    uninitialized."""
    calls = re.compile(r"\bdist\.(all_reduce|all_gather\w*|reduce_scatter\w*|broadcast|send|"
                       r"recv|isend|irecv|batch_isend_irecv|barrier|all_to_all\w*|"
                       r"init_process_group|new_group)\(")
    offenders = []
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if calls.search(line):
                            offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders
    _world(2, lambda mesh: mesh.all_reduce(torch.zeros(1), "data"))
    assert not dist.is_initialized()


def test_bench_all_mesh_legs_emit_the_jax_metric_names(capsys):
    """``bench_all --legs mesh --device cpu --tiny``: the three JAX metric
    names, each line naming its device, backend and world kind."""
    import json

    from distributed_ml_pytorch_tpu_torch import bench_all

    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "mesh"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["metric"] for r in recs] == ["allreduce_2way_gradient_exchange_rate",
                                          "resnet18_8way_dp_step_throughput",
                                          "allreduce_4process_gloo_exchange_rate"]
    assert [r["hardware"] for r in recs] == ["2 gloo ranks as threads, cpu, gloo",
                                            "8 gloo ranks as threads, cpu, gloo",
                                            "4 gloo processes, cpu, gloo"]
    assert all(r["value"] > 0 and "off the card" in r["note"] for r in recs)


def test_mesh_phase_on_the_cpu(capsys):
    """``chip_smoke.py`` phase 26 rehearsed on the CPU at test widths: the
    one-rank world bit for bit, the two gloo processes within the phase's
    tolerances, ``generate_tp``'s tokens equal to ``generate()``'s, and the
    sharded checkpoints' resumes bit for bit."""
    import json
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    launches, errors = cs.phase_mesh(torch, device="cpu", tiny=True)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"phase"')]
    assert [ln["phase"] for ln in lines] == ["mesh_one_rank", "mesh_two_ranks_dp",
                                            "mesh_lm_fsdp", "mesh_lm_tp", "mesh_generate_tp",
                                            "mesh_sharded_resume", "mesh"]
    assert all(ln["ok"] for ln in lines) and not errors
    resume = lines[5]["modes"]
    assert sorted(resume) == ["fsdp", "tp"]
    assert all(m["bit_equal"] and m["checkpoint_bytes"] > 0 and m["resumed_losses"]
               == m["losses"][2:] for m in resume.values())
    assert launches == dict.fromkeys(launches, 0)  # the plain versions on the CPU
