"""The port's chunked DownPour worker against the JAX package's
(``tests/test_chunked_worker.py``, mirrored) and against its own per-step
worker, on the CPU.

- ``downpour_chunk_schedule`` equals the JAX function over a grid of
  cadences, starts, stops and caps;
- the port's chunk step equals the port's per-step device math bit for bit
  (AlexNet, and LeNet with its dropout generator), and the JAX chunk step
  within ``PAYLOAD_TOL`` (the two packages' convolutions sum in different
  orders; AlexNet has no dropout, so both draw nothing);
- ``boundary`` at the schedule's gaps sends the per-step client's codes and
  payloads bit for bit, and the JAX ``boundary``'s codes with its payloads
  within ``PAYLOAD_TOL``;
- the chunked ``train_worker``'s CSV has the JAX chunked worker's rows and
  eval-marked steps, and its training losses and pushes equal the per-step
  worker's bit for bit;
- a push sends what was accumulated when it fired, however late the flusher
  copies it (the accumulator is zeroed in place right after the snapshot);
- a chunk step that fails raises out of ``train_worker``: nothing falls
  back to per-step dispatch.
"""

import csv
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.models import AlexNet as JAlexNet
from distributed_ml_pytorch_tpu.parallel import async_ps as jps
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.ops.fused_update import flat_axpy_plain
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
from distributed_ml_pytorch_tpu_torch.utils import interop
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.serialization import (
    ravel_model_params,
    ravel_tensors,
)

PAYLOAD_TOL = dict(rtol=1e-4, atol=1e-6)
GU = int(tmsg.MessageCode.GradientUpdate)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batches(n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, size=(n, batch, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=(n, batch)).astype(np.int64))


def _jax_alexnet_pair(seed=0):
    jmodel = JAlexNet()
    jparams = jmodel.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)))["params"]
    model = get_model("alexnet", fused_epilogue=True, device="cpu")
    model.load_state_dict(interop.params_from_jax(jax.tree.map(np.asarray, jparams), model))
    return jmodel, jparams, model


@pytest.mark.parametrize("n_push,n_pull,start,stop,max_chunk", [
    (10, 10, 0, 60, 64), (5, 5, 0, 20, 64), (4, 6, 12, 24, 2), (3, 2, 0, 12, 64),
    (10, 10, 40, 100, 4), (1, 1, 0, 5, 64), (7, 3, 5, 50, 8), (10, 10, 0, 781, 64)])
def test_chunk_schedule_matches_jax(n_push, n_pull, start, stop, max_chunk):
    mine = tps.downpour_chunk_schedule(n_push, n_pull, start, stop, max_chunk=max_chunk)
    assert mine == jps.downpour_chunk_schedule(n_push, n_pull, start, stop,
                                               max_chunk=max_chunk)
    assert sum(length for _, length in mine) == stop - start
    if (n_push, n_pull, max_chunk) == (10, 10, 64):
        assert {length for _, length in mine} <= {1, 9}


def _per_step(model, tx, xs, ys, generator=None):
    _, n, pad, accum = tps.init_downpour_accumulator(model)
    state = tx.init(list(model.parameters()))
    step = tps.make_downpour_device_step(model, tx, n, pad)
    losses = []
    for x, y in zip(xs, ys):
        losses.append(loss_and_grads(model, torch.from_numpy(x), torch.from_numpy(y),
                                     generator=generator))
        step(state, accum)
    return torch.stack(losses), accum


def _chunked(model, tx, xs, ys, generator=None, cuts=(2,)):
    _, n, _pad, accum = tps.init_downpour_accumulator(model)
    state = tx.init(list(model.parameters()))
    chunk = tps.make_downpour_chunk_step(model, tx, accum, n)
    bounds = [0, *cuts, len(xs)]
    losses = torch.cat([chunk(state, xs[a:b], ys[a:b], generator)
                        for a, b in zip(bounds, bounds[1:])])
    return losses, accum


@pytest.mark.parametrize("name", ["alexnet", "lenet"])
def test_chunk_step_equals_per_step_device_math_bit_for_bit(name):
    xs, ys = _batches(5, batch=8, seed=3)
    runs = []
    for chunked in (False, True):
        model = get_model(name, fused_epilogue=True, seed=1, device="cpu")
        tx = tps.default_downpour_tx(0.05)
        gen = torch.Generator().manual_seed(11)
        losses, accum = (_chunked if chunked else _per_step)(model, tx, xs, ys, gen)
        runs.append((losses, accum, ravel_model_params(model)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert runs[0][1].abs().sum() > 0


def test_chunk_step_matches_jax_chunk_step():
    jmodel, jparams, model = _jax_alexnet_pair()
    xs, ys = _batches(5, batch=4, seed=4)
    tx = tps.default_downpour_tx(0.05)
    losses, accum = _chunked(model, tx, xs, ys)
    jtx = jps.default_downpour_tx(0.05)
    _, _n, pad, jaccum = jps.init_downpour_accumulator(jparams)
    jchunk = jps.make_downpour_chunk_step(jmodel, jtx, pad)
    jp, _, jaccum, jlosses = jchunk(jparams, jtx.init(jparams), jaccum, jnp.asarray(xs),
                                    jnp.asarray(ys.astype(np.int32)), jax.random.key(0), 0)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **PAYLOAD_TOL)
    np.testing.assert_allclose(accum.numpy(), np.asarray(jaccum), **PAYLOAD_TOL)
    np.testing.assert_allclose(ravel_model_params(model).numpy(),
                               np.asarray(jax.flatten_util.ravel_pytree(jp)[0]), **PAYLOAD_TOL)


def _recording(opt):
    sent = []
    opt._send = lambda code, payload: sent.append((int(code), np.array(payload, np.float32)))
    return sent


def _by_kind(sent):
    return ([p for c, p in sent if c == GU], [c for c, _ in sent if c != GU])


def test_boundary_send_sequence_matches_per_step_and_jax():
    """N = 9 steps at n_push 3, n_pull 2, against no server: the chunked
    client (``boundary`` at the schedule's gaps, then each run as one chunk)
    sends the per-step client's pulls and its pushes bit for bit, and the
    JAX chunked client's codes, its pushes within PAYLOAD_TOL. Pushes ride
    the flusher while pulls leave from the training thread, so each kind's
    own sequence is compared, as the JAX test does."""
    n_steps, n_push, n_pull = 9, 3, 2
    xs, ys = _batches(n_steps, batch=4, seed=5)
    sched = tps.downpour_chunk_schedule(n_push, n_pull, 0, n_steps)
    runs = []
    for chunked in (False, True):
        jmodel, jparams, model = _jax_alexnet_pair()
        world = tmsg.InProcessTransport.create_world(2)
        opt = tps.Asynchronous(model, lr=0.05, n_push=n_push, n_pull=n_pull,
                               transport=world[1])
        sent = _recording(opt)
        if chunked:
            chunk = tps._chunk_step_cache(opt, 64)
            for gap, length in sched:
                opt.boundary(gap)
                chunk(opt.opt_state, xs[gap:gap + length], ys[gap:gap + length])
                opt.idx = gap + length
        else:
            for x, y in zip(xs, ys):
                loss_and_grads(model, torch.from_numpy(x), torch.from_numpy(y))
                opt.step()
        opt.finish()
        runs.append(_by_kind(sent))
    (push_a, pull_a), (push_b, pull_b) = runs
    assert pull_a == pull_b and len(push_a) == len(push_b) == 4  # steps 0, 3, 6 + final
    for a, b in zip(push_a, push_b):
        np.testing.assert_array_equal(a, b)

    jworld = jmsg.InProcessTransport.create_world(2)
    jopt = jps.Asynchronous(jparams, lr=0.05, n_push=n_push, n_pull=n_pull,
                            transport=jworld[1])
    jsent = _recording(jopt)
    jchunk = jps.make_downpour_chunk_step(jmodel, jopt.tx, jopt._pad)
    params = jparams
    for gap, length in sched:
        jopt.boundary(gap)
        params, jopt.opt_state, jopt.accum, _ = jchunk(
            params, jopt.opt_state, jopt.accum, jnp.asarray(xs[gap:gap + length]),
            jnp.asarray(ys[gap:gap + length].astype(np.int32)), jax.random.key(0), gap)
        jopt.idx = gap + length
    jopt.finish()
    jpush, jpull = _by_kind(jsent)
    assert [int(c) for c in jpull] == pull_b and len(jpush) == len(push_b)
    for a, b in zip(push_b, jpush):
        np.testing.assert_allclose(a, b, **PAYLOAD_TOL)


def _worker_args(parser, chunked, model="lenet", steps=20, batch=8, log_interval=4):
    return parser.parse_args([
        "--epochs", "1", "--synthetic-data", "--synthetic-train-size", str(steps * batch),
        "--synthetic-test-size", "16", "--batch-size", str(batch), "--log-interval",
        str(log_interval), "--model", model, "--chunked-dispatch", chunked,
        "--log-dir", "unused"])


def _rows(logger):
    return [(r["iteration"], "test_loss" in r) for r in logger.records]


class _Recording(tmsg.InProcessTransport):
    def __init__(self, *a):
        super().__init__(*a)
        self.pushes = []

    def send(self, code, payload, dst=0):
        if int(code) == GU:
            self.pushes.append(np.array(payload, np.float32))
        super().send(code, payload, dst)


def test_chunked_train_worker_csv_matches_jax_and_per_step(tmp_path):
    from distributed_ml_pytorch_tpu.training import cli as jcli
    from distributed_ml_pytorch_tpu_torch.training import cli as tcli

    results = {}
    for chunked in ("off", "on"):
        boxes = tmsg.InProcessTransport.create_world(2)[0]._boxes
        transport = _Recording(1, boxes)
        args = _worker_args(tcli.build_parser(), chunked)
        args.log_dir = str(tmp_path / chunked)
        _model, logger = tps.train_worker(args, transport, device="cpu")
        results[chunked] = (logger, transport.pushes, ravel_model_params(_model))
    jargs = _worker_args(jcli.build_parser(), "on")
    jargs.log_dir = str(tmp_path / "jax")
    _p, jlogger = jps.train_worker(jargs, jmsg.InProcessTransport.create_world(2)[1])

    per_step, chunked = results["off"], results["on"]
    assert _rows(chunked[0]) == _rows(jlogger) == _rows(per_step[0])
    assert [i for i, ev in _rows(jlogger) if ev] == [4, 8, 12, 16]
    assert ([r["training_loss"] for r in chunked[0].records]
            == [r["training_loss"] for r in per_step[0].records])
    assert len(chunked[1]) == len(per_step[1]) == 3  # steps 0 and 10, and the final flush
    for a, b in zip(chunked[1], per_step[1]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(chunked[2], per_step[2])
    with open(chunked[0].to_csv("node1.csv"), newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert [int(r["iteration"]) for r in rows] == list(range(20))


def test_push_sends_what_was_accumulated_however_late_the_copy(monkeypatch):
    """The accumulator is one tensor, zeroed in place after each push's
    snapshot, and the flusher copies the snapshot while the next steps run.
    With the copy delayed past several more steps, every push still equals
    a reference accumulation taken by hand at the push (nonzero, not the
    zeroed or the later buffer)."""
    slow = tps.PushFlusher._fetch

    def late(self, snap, ready):
        time.sleep(0.05)
        return slow(self, snap, ready)

    monkeypatch.setattr(tps.PushFlusher, "_fetch", late)
    xs, ys = _batches(8, batch=4, seed=6)
    model = get_model("alexnet", fused_epilogue=True, seed=2, device="cpu")
    ref = get_model("alexnet", fused_epilogue=True, seed=2, device="cpu")
    world = tmsg.InProcessTransport.create_world(2)
    opt = tps.Asynchronous(model, lr=0.05, n_push=2, n_pull=100, transport=world[1])
    sent = _recording(opt)
    tx = tps.default_downpour_tx(0.05)
    state = tx.init(list(ref.parameters()))
    names, params = zip(*ref.named_parameters())
    n = sum(p.numel() for p in params)
    acc, flat, expected = torch.zeros(n), torch.zeros(n), []
    for i, (x, y) in enumerate(zip(xs, ys)):
        loss_and_grads(model, torch.from_numpy(x), torch.from_numpy(y))
        opt.step()
        loss_and_grads(ref, torch.from_numpy(x), torch.from_numpy(y))
        updates = tx.update([p.grad for p in params], state, list(params))
        ravel_tensors(ref, dict(zip(names, updates)), out=flat)
        flat_axpy_plain(acc, flat, 1.0)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        if i % 2 == 0:
            expected.append(acc.clone())
            acc.zero_()
    opt.finish()
    expected.append(acc)
    pushes = _by_kind(sent)[0]
    assert len(pushes) == len(expected) == 5
    for got, want in zip(pushes, expected):
        assert np.abs(got).sum() > 0
        np.testing.assert_array_equal(got, want.numpy())


def test_a_failing_chunk_step_raises_out_of_the_worker(monkeypatch):
    """No fallback: when the chunked path's dispatch fails (on the card, a
    capture or a replay), ``train_worker`` raises; it never goes on with
    per-step dispatch."""
    from distributed_ml_pytorch_tpu_torch.training import cli as tcli

    def broken(*_a, **_k):
        def chunk(*_a, **_k):
            raise RuntimeError("CUDA graph capture failed")
        return chunk

    monkeypatch.setattr(tps, "make_downpour_chunk_step", broken)
    stepped = []
    monkeypatch.setattr(tps.Asynchronous, "step", lambda self: stepped.append(1))
    transport = _Recording(1, tmsg.InProcessTransport.create_world(2)[0]._boxes)
    args = _worker_args(tcli.build_parser(), "on")
    with pytest.raises(RuntimeError, match="capture failed"):
        tps.train_worker(args, transport, device="cpu")
    assert not stepped and not transport.pushes


def test_chunked_dispatch_auto_follows_the_device_and_steps_per_dispatch(monkeypatch):
    """``auto`` chunks on a CUDA device or with ``--steps-per-dispatch`` > 1
    (which also caps a run's length); on the CPU with 1 it runs per step."""
    from distributed_ml_pytorch_tpu_torch.training import cli as tcli

    made = []
    real = tps.make_downpour_chunk_step
    monkeypatch.setattr(tps, "make_downpour_chunk_step",
                        lambda *a, **k: made.append(k["capacity"]) or real(*a, **k))
    for extra, want in (([], []), (["--steps-per-dispatch", "4"], [4])):
        made.clear()
        args = tcli.build_parser().parse_args(
            ["--epochs", "1", "--synthetic-data", "--synthetic-train-size", "48",
             "--synthetic-test-size", "8", "--batch-size", "8", "--model", "lenet",
             "--log-dir", "unused", *extra])
        transport = _Recording(1, tmsg.InProcessTransport.create_world(2)[0]._boxes)
        _m, logger = tps.train_worker(args, transport, device="cpu")
        assert made == want and len(logger.records) == 6
