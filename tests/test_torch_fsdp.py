"""FSDP / ZeRO-3 (``parallel/fsdp.py``) of the port on worlds of threads,
case for case as the JAX package's ``tests/test_fsdp.py``.

Against the JAX FSDP steps on a two-device mesh, from the same weights and
batches: a float32 AlexNet (two ranks of batch 8, three SGD steps) and the
tiny LM (vocab 64, d_model 32, 4 heads, 2 layers, batch 16 × 32, SGD with
momentum 0.9, two steps). Tolerance: losses rtol 1e-5; parameters rtol
1e-5, atol 2e-6 (as ``tests/test_torch_sync_dp.py``). The port against
itself: FSDP equals sync DP (their mean gradients are the same sums), bit
for bit with plain SGD and within rtol 1e-6 with Adam and global-norm
clipping (the clip's norm sums the squares in another order); K steps a
dispatch equal K single steps bit for bit. ``param_shard_fraction`` equals
the JAX package's exactly for AlexNet and the LM. ``--mode fsdp`` of the
trainer CLI and of ``train_lm`` run as two processes through ``launch.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_ml_pytorch_tpu.models import AlexNet as JAlexNet
from distributed_ml_pytorch_tpu.models import TransformerLM as JLM
from distributed_ml_pytorch_tpu.parallel import fsdp as jfsdp
from distributed_ml_pytorch_tpu.parallel.seq_parallel import next_token_targets
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh as jmake_mesh
from distributed_ml_pytorch_tpu.training import trainer as jtr
from distributed_ml_pytorch_tpu_torch.models import TransformerLM, get_model
from distributed_ml_pytorch_tpu_torch.parallel import fsdp, sync
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
from distributed_ml_pytorch_tpu_torch.training import cli
from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
from distributed_ml_pytorch_tpu_torch.utils import interop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.05
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=2e-6)
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=64)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mesh2():
    return jmake_mesh({"data": 2}, devices=jax.devices()[:2])


@pytest.fixture(scope="module")
def jax_init():
    jparams = JAlexNet().init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree.map(np.asarray, jparams)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=(n,)).astype(np.int32))


def _port_alexnet(params):
    model = get_model("alexnet", device="cpu")
    model.load_state_dict(interop.params_from_jax(params, model))
    return model


def test_fsdp_specs_shard_largest_divisible_dim():
    tree = {
        "conv": (64, 3, 11, 11),   # OIHW: 64 is the largest dim divisible by 8
        "dense": (10, 256),        # (out, in): 256 divides by 8, 10 does not
        "bias": (6,),              # nothing divides: replicated
        "scalar": (),
        "tie": (16, 16),           # a tie goes to the trailing dim
    }
    assert fsdp.fsdp_specs(tree, 8) == {"conv": 0, "dense": 1, "bias": None,
                                        "scalar": None, "tie": 1}


def _sharded_leaves_jax(params, n):
    specs = jfsdp.fsdp_specs(params, n)
    flat = jax.tree_util.tree_leaves_with_path(params)
    return sorted(tuple(sorted(leaf.shape)) for (path, leaf), spec in
                  zip(flat, jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
                      s, jax.sharding.PartitionSpec)))
                  if any(a is not None for a in spec))


def test_fsdp_param_memory_is_actually_sharded(mesh2, jax_init):
    """The per-rank parameter fraction equals the JAX package's exactly (the
    same leaves shard, each to a half), for AlexNet and the LM; the sharded
    leaves are the same set up to the layout's transposition."""
    jlm = JLM(**LM)
    jlm_params = jlm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    want = {}
    for name, model, params in (("alexnet", JAlexNet(), jax_init), ("lm", jlm, jlm_params)):
        tx = optax.sgd(0.05)
        sample = jnp.zeros((1, 32, 32, 3)) if name == "alexnet" else jnp.zeros((1, 8), jnp.int32)
        state, _ = jfsdp.create_fsdp_train_state(
            lambda r, m=model, s=sample, t=tx: jtr.TrainState.create(
                m.init(r, s)["params"], t), jax.random.key(0), mesh2)
        want[name] = (jfsdp.param_shard_fraction(state, mesh2),
                      _sharded_leaves_jax(params, 2))

    def rank(world):
        mesh = make_mesh(world=world)
        out = {}
        for name, model in (("alexnet", get_model("alexnet", device="cpu")),
                            ("lm", TransformerLM(**LM, device="cpu"))):
            state = fsdp.create_fsdp_train_state(model, ttr.SGD(0.05), mesh)
            # the full leaves' shapes (sorted: the layouts transpose), from
            # the shards: the parameters' data are freed between steps
            full = [tuple(sorted((s.shape[0] * 2, *s.shape[1:]))) for s, d in
                    zip(state.sharding.shards, state.sharding.dims) if d is not None]
            out[name] = (fsdp.param_shard_fraction(state, mesh), sorted(full))
        return out

    got = run_threaded(2, rank)[0]
    for name in ("alexnet", "lm"):
        assert got[name][0] == want[name][0], name
        assert got[name][1] == want[name][1], name
    assert got["alexnet"][0] < 0.6


def test_fsdp_step_matches_single_device(mesh2, jax_init):
    """Two-rank FSDP on batch 16 == the JAX FSDP step on two devices, and ==
    the port's sync DP bit for bit."""
    x, y = _batches(16)
    jmodel = JAlexNet()
    tx = optax.sgd(LR)

    def init_fn(rng):
        return jtr.TrainState.create(jax.tree.map(jnp.asarray, jax_init), tx)

    jstate, _shardings = jfsdp.create_fsdp_train_state(init_fn, jax.random.key(0), mesh2)
    jstep = jfsdp.make_fsdp_train_step(jmodel, tx, mesh2, _shardings)
    bx, by = jfsdp.shard_fsdp_batch(mesh2, x, y)
    jlosses = []
    for _ in range(3):
        jstate, loss = jstep(jstate, bx, by, jax.random.key(7))
        jlosses.append(float(loss))

    def rank(world):
        mesh = make_mesh(world=world)
        a, b = _port_alexnet(jax_init), _port_alexnet(jax_init)
        sa = fsdp.create_fsdp_train_state(a, ttr.SGD(LR), mesh)
        step = fsdp.make_fsdp_train_step(a, ttr.SGD(LR), mesh)
        sx, sy = fsdp.shard_fsdp_batch(mesh, x, y)
        losses = [float(step(sa, sx, sy)[1]) for _ in range(3)]
        sa.sharding.gather()
        sb = ttr.create_train_state(b, ttr.SGD(LR))
        dstep = sync.make_sync_train_step(b, ttr.SGD(LR), mesh)
        dp = [float(dstep(sb, sx, sy)[1]) for _ in range(3)]
        return losses, dp, a.state_dict(), b.state_dict()

    losses, dp, params, dp_params = run_threaded(2, rank)[0]
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    assert losses == dp
    ref = interop.params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                  _port_alexnet(jax_init))
    for name, p in params.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), err_msg=name, **PARAM_TOL)
        assert torch.equal(p, dp_params[name]), name


def test_fsdp_clipping_sums_over_the_shards(jax_init):
    """Adam with global-norm clipping: the norm over the shards (summed over
    the ranks) is sync DP's norm over the full gradients."""
    x, y = _batches(16, seed=8)

    def rank(world):
        mesh = make_mesh(world=world)
        a, b = _port_alexnet(jax_init), _port_alexnet(jax_init)
        tx = ttr.build_tx("adam", 1e-3, grad_clip=0.05)
        sa = fsdp.create_fsdp_train_state(a, tx, mesh)
        step = fsdp.make_fsdp_train_step(a, tx, mesh)
        sb = ttr.create_train_state(b, tx)
        dstep = sync.make_sync_train_step(b, tx, mesh)
        sx, sy = sync.shard_batch(mesh, x, y)
        for _ in range(2):
            step(sa, sx, sy)
            dstep(sb, sx, sy)
        sa.sharding.gather()
        return a.state_dict(), b.state_dict()

    fs, dp = run_threaded(2, rank)[0]
    for name, p in fs.items():
        np.testing.assert_allclose(p.numpy(), dp[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def _train_fsdp(tmp_path, k, tag):
    args = cli.build_parser().parse_args([
        "--mode", "fsdp", "--epochs", "1", "--synthetic-data",
        "--synthetic-train-size", "128", "--synthetic-test-size", "32",
        "--batch-size", "4", "--model", "lenet", "--lr", "0.05", "--backend", "cpu",
        "--log-interval", "100", "--log-dir", str(tmp_path / tag),
        "--steps-per-dispatch", str(k)])

    def rank(world):
        state, logger = fsdp.train_fsdp(args, make_mesh(world=world))
        state.sharding.gather()
        return state.step, [r["training_loss"] for r in logger.records], [
            p.detach().clone() for p in state.model.parameters()]

    return run_threaded(2, rank)[0]


def test_fsdp_training_loop_end_to_end(tmp_path):
    step, losses, _ = _train_fsdp(tmp_path, 1, "e2e")
    assert step == 128 // (4 * 2)
    assert losses[-1] < losses[0]


def test_fsdp_chunked_dispatch_matches_per_step(tmp_path):
    per = _train_fsdp(tmp_path, 1, "per")
    chunk = _train_fsdp(tmp_path, 4, "chunk")
    assert per[0] == chunk[0] and per[1] == chunk[1]
    assert all(torch.equal(a, b) for a, b in zip(per[2], chunk[2]))


def test_fsdp_lm_matches_single_device_and_shards_momentum(mesh2):
    """Transformer FSDP with momentum against the JAX FSDP LM step on two
    devices; the momentum buffers are the shards' size."""
    jlm = JLM(**LM)
    tx = optax.sgd(0.05, momentum=0.9)
    tokens = np.random.default_rng(0).integers(0, 64, size=(16, 32)).astype(np.int32)
    targets = next_token_targets(tokens)
    params = jax.tree.map(np.asarray, jlm.init(jax.random.key(1),
                                               jnp.zeros((1, 8), jnp.int32))["params"])

    def init_fn(rng):
        return jtr.TrainState.create(jax.tree.map(jnp.asarray, params), tx)

    jstate, shardings = jfsdp.create_fsdp_train_state(init_fn, jax.random.key(1), mesh2)
    jstep = jfsdp.make_fsdp_lm_train_step(jlm, tx, mesh2, shardings)
    tok, tgt = jfsdp.shard_fsdp_batch(mesh2, tokens, targets)
    jlosses = []
    for _ in range(2):
        jstate, loss = jstep(jstate, tok, tgt)
        jlosses.append(float(loss))

    def rank(world):
        mesh = make_mesh(world=world)
        model = TransformerLM(**LM, device="cpu")
        model.load_state_dict(interop.params_from_jax(params, model))
        ptx = ttr.SGD(0.05, momentum=0.9)
        state = fsdp.create_fsdp_train_state(model, ptx, mesh)
        step = fsdp.make_fsdp_lm_train_step(model, ptx, mesh)
        a, b = fsdp.shard_fsdp_batch(mesh, tokens, targets)
        losses = [float(step(state, a, b)[1]) for _ in range(2)]
        traces = [(t.numel(), s.numel(), s.numel() * (1 if d is None else 2)) for t, s, d in
                  zip(state.opt_state.slots["trace"], state.sharding.shards,
                      state.sharding.dims)]
        state.sharding.gather()
        return losses, model.state_dict(), traces

    losses, got, traces = run_threaded(2, rank)[0]
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    ref = interop.params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                  TransformerLM(**LM, device="cpu"))
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), err_msg=name, **PARAM_TOL)
    assert all(t == s for t, s, _ in traces)
    assert sum(t for t, _, _ in traces) < 0.6 * sum(full for _, _, full in traces)


def _launch(tmp_path, entry, argv):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.launch", "--world-size", "2",
         "--entry", entry, "--", *argv],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)


def test_fsdp_cli_two_processes(tmp_path):
    proc = _launch(tmp_path, "cli", [
        "--mode", "fsdp", "--dist-backend", "gloo", "--backend", "cpu", "--model", "lenet",
        "--epochs", "1", "--synthetic-data", "--synthetic-train-size", "128",
        "--synthetic-test-size", "16", "--batch-size", "8", "--log-interval", "4",
        "--log-dir", str(tmp_path)])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "of params/rank" in proc.stdout
    rows = [np.genfromtxt(tmp_path / f"node{r}.csv", delimiter=",", names=True)
            for r in (0, 1)]
    np.testing.assert_array_equal(rows[0]["training_loss"], rows[1]["training_loss"])


def test_train_lm_fsdp_two_processes(tmp_path):
    proc = _launch(tmp_path, "train_lm", [
        "--mode", "fsdp", "--dist-backend", "gloo", "--device", "cpu", "--steps", "3",
        "--batch", "4", "--seq", "32", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
        "--d-ff", "64"])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "2-way fsdp (0.500 of params/rank) on cpu" in proc.stdout
    assert proc.stdout.count("final loss") == 1  # rank 0 prints
