"""The port's command line, launcher and import boundary, on the CPU.

- ``--no-distributed --backend cpu`` trains a few steps and writes the
  reference CSV schema, the same header the JAX package's logger writes;
- ``launch.py`` runs a tiny three-process TCP world (server + 2 workers);
- flags the port does not implement are rejected, and ``--backend cuda``
  without a card raises instead of falling back; the trainer's flags take
  the JAX CLI's names, defaults and choices, and ``--mode ps`` refuses the
  ones it does not implement;
- no module of the port imports JAX, flax, optax or the JAX package.
"""

import csv
import os
import subprocess
import sys

import pytest
import torch

from distributed_ml_pytorch_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from distributed_ml_pytorch_tpu_torch.training import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "distributed_ml_pytorch_tpu_torch")
TINY = ["--epochs", "1", "--synthetic-data", "--synthetic-train-size", "64",
        "--synthetic-test-size", "16", "--batch-size", "16", "--log-interval", "2"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _header(path):
    with open(path, newline="") as fh:
        return next(csv.reader(fh))


def test_no_distributed_writes_reference_csv_schema(tmp_path):
    rc = cli.main(["--no-distributed", "--backend", "cpu", "--model", "lenet",
                   "--log-dir", str(tmp_path), *TINY])
    assert rc == 0
    path = tmp_path / "single.csv"
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 4
    assert rows[2]["test_loss"] != "" and rows[1]["test_loss"] == ""
    ref = JMetricsLogger(str(tmp_path / "jax"))
    ref.log_step(0, 1.0)
    ref.log_step(1, 1.0, test_loss=2.0, test_accuracy=0.5)
    assert _header(path) == _header(ref.to_csv("ref.csv"))


def test_launch_three_process_tcp_world(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.launch", "--world-size", "3",
         "--", "--backend", "cpu", "--model", "lenet", "--log-dir", str(tmp_path),
         "--worker-timeout", "0", "--heartbeat-interval", "0.5", *TINY],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "parameter server: all workers done" in proc.stdout
    for rank in (1, 2):
        assert _header(tmp_path / f"node{rank}.csv")[:4] == [
            "index", "timestamp", "iteration", "training_loss"]


@pytest.mark.parametrize("flag", [["--manifest-path", "m"], ["--compress", "int8"],
                                  ["--mode", "sync"],
                                  ["--dtype", "float16"], ["--backend", "tpu"],
                                  ["--n-servers", "2"], ["--profile-dir", "prof"]])
def test_unimplemented_flags_are_rejected(flag):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(flag)


NEW_FLAGS = ["dtype", "optimizer", "weight_decay", "grad_clip", "lr_schedule", "grad_accum",
             "steps_per_dispatch", "prefetch", "ckpt_dir", "ckpt_every", "ckpt_keep", "resume",
             "download", "momentum"]


def _actions(parser):
    return {a.dest: a for a in parser._actions}


def test_trainer_flags_take_the_jax_names_defaults_and_choices():
    from distributed_ml_pytorch_tpu.training import cli as jcli

    mine, ref = _actions(cli.build_parser()), _actions(jcli.build_parser())
    for dest in NEW_FLAGS:
        assert mine[dest].option_strings == ref[dest].option_strings, dest
        assert mine[dest].default == ref[dest].default, dest
        assert (mine[dest].choices and tuple(mine[dest].choices)) == (
            ref[dest].choices and tuple(ref[dest].choices)), dest
        assert mine[dest].type == ref[dest].type, dest


@pytest.mark.parametrize("flag", [["--ckpt-dir", "ck"], ["--resume"],
                                  ["--steps-per-dispatch", "4"]])
def test_ps_mode_refuses_the_single_process_flags(flag, capsys, monkeypatch):
    """The checkpoint flags and ``--steps-per-dispatch`` were refused with
    ``--mode ps`` until the server's durability plane and the chunked worker
    were ported: now ``main`` hands them to ``run_ps_process`` unrefused."""
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps

    seen = []
    monkeypatch.setattr(async_ps, "run_ps_process", lambda args: seen.append(args) or 0)
    assert cli.main(["--rank", "1", *flag]) == 0
    assert "not ported yet" not in capsys.readouterr().err
    (args,) = seen
    assert (args.ckpt_dir, args.resume, args.steps_per_dispatch) == (
        "ck" if "--ckpt-dir" in flag else "", "--resume" in flag,
        4 if "--steps-per-dispatch" in flag else 1)


PS_FLAGS = ["wal", "admission", "admission_z", "admission_warmup", "rejoin",
            "staleness_damping", "chunked_dispatch", "ckpt_every", "transport", "reliable"]


def test_ps_flags_take_the_jax_names_defaults_and_choices():
    from distributed_ml_pytorch_tpu.training import cli as jcli

    mine, ref = _actions(cli.build_parser()), _actions(jcli.build_parser())
    for dest in PS_FLAGS:
        assert mine[dest].option_strings == ref[dest].option_strings, dest
        assert mine[dest].default == ref[dest].default, dest
        assert (mine[dest].choices and tuple(mine[dest].choices)) == (
            ref[dest].choices and tuple(ref[dest].choices)), dest
        assert mine[dest].type == ref[dest].type, dest
    for flag in (["--manifest-path", "m"], ["--combine", "adasum"], ["--coord", "h:1"],
                 ["--server-opt", "adam"], ["--metrics-dump", "-"], ["--sync-every", "2"],
                 ["--compress-topk", "0.1"], ["--profile-steps", "3"]):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(flag)


def test_no_distributed_bf16_chunked_accumulating_run(tmp_path):
    rc = cli.main(["--no-distributed", "--backend", "cpu", "--model", "alexnet", "--dtype",
                   "bfloat16", "--optimizer", "adamw", "--lr-schedule", "cosine",
                   "--grad-clip", "1.0", "--grad-accum", "2", "--steps-per-dispatch", "3",
                   "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
                   "--log-dir", str(tmp_path), *TINY])
    assert rc == 0
    with open(tmp_path / "single.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 4 and rows[2]["test_loss"] != ""
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "4"]


def test_cuda_without_a_card_raises(monkeypatch):
    from distributed_ml_pytorch_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


BLOCKER = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "optax", "distributed_ml_pytorch_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import distributed_ml_pytorch_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "optax", "distributed_ml_pytorch_tpu")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", BLOCKER], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for word in ("import jax", "from jax", "import flax", "from flax",
                             "import optax", "distributed_ml_pytorch_tpu."):
                    assert word not in text, (f, word)
