"""The DownPour world as separate processes on the CPU, on the reliable wire.

- ``launch_world(3, ...)`` with ``--reliable --wal --ckpt-dir``: a server
  and two LeNet workers, each its own process over TCP, exit 0; every
  worker's CSV is written and the server's checkpoint holds the envelopes
  of its last applies;
- the same world with worker 2 killed partway (SIGKILL, after its second
  epoch begins) and started again with ``--rejoin``: the restarted process
  reconnects over TCP to the running server, which admits it after the
  rendezvous, and the world ends with every exit code 0; the server's
  checkpoint shows the new life's pushes applied, each once, under a
  second, larger incarnation.
"""

import json
import os
import subprocess
import sys
import time

from distributed_ml_pytorch_tpu_torch.launch import _free_port, launch_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ["--backend", "cpu", "--model", "lenet", "--synthetic-data",
        "--synthetic-train-size", "640", "--synthetic-test-size", "64",
        "--test-batch-size", "64", "--log-interval", "100000", "--worker-timeout", "0"]


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")


def test_launch_world_reliable_with_wal(tmp_path, monkeypatch):
    for k, v in _env().items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    rc = launch_world(3, [*TINY, "--epochs", "1", "--reliable", "--wal",
                          "--ckpt-dir", str(tmp_path / "ps"), "--log-dir", str(tmp_path)])
    assert rc == 0
    for rank in (1, 2):
        assert (tmp_path / f"node{rank}.csv").stat().st_size > 0
    with open(tmp_path / "ps" / "ps_meta.json") as f:
        meta = json.load(f)
    # 10 steps a worker at n_push 10: the push of step 0 and the final one
    assert meta["apply_seq"] == 4
    assert sorted(s for s, _i, _q in meta["recent_envelopes"]) == [1, 1, 2, 2]
    assert all(inc for _s, inc, _q in meta["recent_envelopes"])


def _spawn(args, **kw):
    cmd = [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.training.cli",
           "--mode", "ps", *args]
    return subprocess.Popen(cmd, env=_env(), text=True, **kw)


def test_killed_worker_rejoins_over_tcp_and_the_world_ends_cleanly(tmp_path):
    port = _free_port()
    common = ["--world-size", "3", "--port", port, *TINY, "--epochs", "20", "--reliable",
              "--wal", "--ckpt-dir", str(tmp_path / "ps"), "--log-dir", str(tmp_path)]
    out = subprocess.PIPE
    server = _spawn([*common, "--rank", "0", "--server"], stdout=out, stderr=subprocess.STDOUT)
    worker1 = _spawn([*common, "--rank", "1"], stdout=subprocess.DEVNULL,
                     stderr=subprocess.DEVNULL)
    worker2 = _spawn([*common, "--rank", "2"], stdout=out, stderr=subprocess.STDOUT)
    procs = [server, worker1, worker2]
    try:
        for line in worker2.stdout:
            if line.startswith("Training for epoch 2"):
                break
        assert worker2.poll() is None, "worker 2 ended before it could be killed"
        worker2.kill()
        worker2.wait(timeout=30)
        time.sleep(0.5)
        rejoined = _spawn([*common, "--rank", "2", "--rejoin"], stdout=out,
                          stderr=subprocess.STDOUT)
        procs.append(rejoined)
        r_out, _ = rejoined.communicate(timeout=120)
        assert rejoined.returncode == 0, r_out[-3000:]
        assert "rejoin pull unanswered" not in r_out
        assert worker1.wait(timeout=120) == 0
        s_out, _ = server.communicate(timeout=120)
        assert server.returncode == 0, s_out[-3000:]
        assert "parameter server: all workers done" in s_out
        assert (tmp_path / "node2.csv").stat().st_size > 0
        with open(tmp_path / "ps" / "ps_meta.json") as f:
            meta = json.load(f)
        lives = {}
        for sender, inc, _seq in meta["recent_envelopes"]:
            if sender == 2:
                lives[inc] = lives.get(inc, 0) + 1
        assert len(lives) == 2, lives
        first, second = sorted(lives)
        assert lives[first] >= 1
        # the restarted life's whole run: 20 epochs of 10 steps at n_push 10
        # push at steps 0, 10, ..., 190 and once more at the end
        assert lives[second] == 21, lives
        assert meta["applied_by_sender"]["2"] == lives[first] + lives[second]
        assert meta["apply_seq"] == sum(meta["applied_by_sender"].values())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
