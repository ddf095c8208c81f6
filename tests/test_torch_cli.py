"""The port's command line, launcher and import boundary, on the CPU.

- ``--no-distributed --backend cpu`` trains a few steps and writes the
  reference CSV schema, the same header the JAX package's logger writes;
- ``launch.py`` runs a tiny three-process TCP world (server + 2 workers);
- flags the port does not implement are rejected, and ``--backend cuda``
  without a card raises instead of falling back;
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


@pytest.mark.parametrize("flag", [["--wal"], ["--compress", "int8"], ["--mode", "sync"],
                                  ["--dtype", "bfloat16"], ["--backend", "tpu"],
                                  ["--n-servers", "2"], ["--resume"]])
def test_unimplemented_flags_are_rejected(flag):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(flag)


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
