"""The port's admission gate, quarantine and nack handling against the JAX
package's (``tests/test_health.py``, mirrored).

- ``GradientAdmission`` reaches the JAX gate's verdicts, reason, norm and z
  exactly (both are numpy), over warm-up, outlier, nonfinite, per-sender,
  sign-flip and winsorized (boiling-frog) sequences, and its statistics
  match;
- the server quarantines a rejected push: an ``UpdateNack`` frame equal to
  the JAX server's, and no accounting, no apply and no log record, so a
  restore after a burst of poison is clean;
- a single-server worker that is nacked resyncs with a pull and holds its
  updates until the pulled vector is installed.
"""

import time

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.parallel.async_ps import ParameterServer as JServer
from distributed_ml_pytorch_tpu.utils import health as jhealth
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu.utils.metrics import EwmaMeanVar as JEwmaMeanVar
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
from distributed_ml_pytorch_tpu_torch.utils import health as thealth
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils import metrics as tmetrics
from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

GU = tmsg.MessageCode.GradientUpdate


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _warmup_outlier():
    clean = np.full(64, 0.01, np.float32)
    return [(1, clean), (1, clean * 50), (1, clean), (1, clean * 1000), (1, clean)]


def _nonfinite():
    nan = np.full(16, 0.1, np.float32)
    nan[7] = np.nan
    inf = np.full(16, 0.1, np.float32)
    inf[3] = np.inf
    big = np.full(16, 3e38, np.float32)
    return [(2, nan), (2, inf), (2, big), (2, np.full(16, 0.1, np.float32))]


def _per_sender():
    out = []
    for _ in range(4):
        out += [(1, np.full(32, 0.001, np.float32)), (2, np.full(32, 10.0, np.float32))]
    return out + [(1, np.full(32, 10.0, np.float32)), (2, np.full(32, 10.0, np.float32))]


def _sign_flip():
    clean = np.linspace(-0.1, 0.1, 64).astype(np.float32)
    return [(1, clean)] * 4 + [(1, -clean)]


def _boiling_frog():
    x = np.full(64, 0.01, np.float32)
    seq = [(1, x)] * 4
    for _ in range(6):
        x = x * 15.0
        seq.append((1, x))
    return seq


def _random_walk():
    rng = np.random.default_rng(5)
    return [(1 + i % 3, (rng.normal(size=128) * np.exp(rng.normal() * 2)).astype(np.float32))
            for i in range(60)]


@pytest.mark.parametrize("seq,kw", [
    (_warmup_outlier, dict(z_max=6.0, warmup=3)), (_nonfinite, dict(warmup=100)),
    (_per_sender, dict(z_max=6.0, warmup=2)), (_sign_flip, dict(z_max=6.0, warmup=2)),
    (_boiling_frog, dict(z_max=6.0, warmup=3)),
    (_random_walk, dict(z_max=2.0, warmup=4))],
    ids=["warmup_outlier", "nonfinite", "per_sender", "sign_flip", "boiling_frog",
         "random_walk"])
def test_admission_verdicts_equal_jax(seq, kw):
    mine, ref = thealth.GradientAdmission(**kw), jhealth.GradientAdmission(**kw)
    verdicts = []
    for sender, payload in seq():
        a, b = mine.evaluate(sender, payload), ref.evaluate(sender, payload)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == b[0]
            np.testing.assert_equal(a[1:], b[1:])  # norm and z exactly (NaN too)
        verdicts.append(a)
    assert mine.snapshot() == ref.snapshot()
    assert (mine.admitted, mine.rejected) == (ref.admitted, ref.rejected)
    assert any(v is not None for v in verdicts) != (seq is _sign_flip)


def test_admission_pinned_behaviours():
    g = thealth.GradientAdmission(z_max=6.0, warmup=3)
    clean = np.full(64, 0.01, np.float32)
    for x in (clean, clean * 50, clean):
        assert g.evaluate(1, x) is None
    before = g.snapshot()[1]
    verdict = g.evaluate(1, clean * 1000)
    assert verdict[0] == thealth.NACK_NORM_OUTLIER and verdict[2] > 6.0
    assert g.snapshot()[1] == before  # a rejected sample never folds in
    assert thealth.clamp_finite32(float("inf")) == jhealth.clamp_finite32(float("inf"))
    assert thealth.clamp_finite32(float("nan")) == 0.0
    assert thealth.NACK_REASONS == jhealth.NACK_REASONS
    ewma, ref = tmetrics.EwmaMeanVar(), JEwmaMeanVar()
    for x, w in ((1.0, None), (4.0, 0.5), (-2.0, None), (9.0, 1.0)):
        ewma.update(x, winsor=w)
        ref.update(x, winsor=w)
        assert (ewma.mean, ewma.var, ewma.count, ewma.sigma(0.1)) == (
            ref.mean, ref.var, ref.count, ref.sigma(0.1))
    with pytest.raises(ValueError):
        thealth.GradientAdmission(warmup=0)


def _servers(tmp_path, **kw):
    tworld = tmsg.InProcessTransport.create_world(3)
    jworld = jmsg.InProcessTransport.create_world(3)
    mine = tps.ParameterServer(params=np.zeros(8, np.float32), transport=tworld[0],
                               admission=thealth.GradientAdmission(z_max=6.0, warmup=1),
                               ckpt_dir=str(tmp_path / "port"), ckpt_every=0, wal=True, **kw)
    ref = JServer(params=np.zeros(8, np.float32), transport=jworld[0],
                  admission=jhealth.GradientAdmission(z_max=6.0, warmup=1),
                  ckpt_dir=str(tmp_path / "jax"), ckpt_every=0, wal=True, **kw)
    return (mine, tworld), (ref, jworld)


def test_quarantine_nacks_skips_accounting_and_never_reaches_the_wal(tmp_path):
    """Pushes good, NaN, good, a 1e6x outlier, Inf, good from worker 1 and
    good from worker 2, in the same order to both servers: the same nacks
    (frames equal), the same clock, vector and log; the log replays to the
    live vector with no poisoned record, in a fresh server of either
    package."""
    good = np.full(8, 0.01, np.float32)
    nan, inf = np.full(8, np.nan, np.float32), good.copy()
    inf[2] = np.inf
    seq = [(1, good), (1, nan), (1, good * 2), (1, good * 1e6), (1, inf), (2, good),
           (1, good)]
    nacks = {}
    (mine, tworld), (ref, jworld) = _servers(tmp_path)
    for name, (ps, world) in (("port", (mine, tworld)), ("jax", (ref, jworld))):
        for sender, payload in seq:
            ps.handle(sender, GU, payload)
        ps.commit()
        got = []
        while (m := world[1].recv(timeout=0.05)) is not None:
            got.append((int(m[1]), m[2]))
        nacks[name] = got
        assert ps.quarantined == 3 and ps.nacks_sent == 3
        assert ps.quarantined_by_sender == {1: 3}
        assert ps._apply_seq == 4 and ps.applied_by_sender == {1: 3, 2: 1}
        assert ps.staleness.version == 4 and np.isfinite(ps.central).all()
        assert ps.wal.appended == 4
    assert [c for c, _ in nacks["port"]] == [int(tmsg.MessageCode.UpdateNack)] * 3
    for (_, a), (_, b) in zip(nacks["port"], nacks["jax"]):
        np.testing.assert_array_equal(a, b)
        assert np.isfinite(a).all()
    assert [int(f[0]) for _, f in nacks["port"]] == [1, 2, 1]
    np.testing.assert_array_equal(mine.central, ref.central)
    for cls, d in ((tps.ParameterServer, "port"), (JServer, "port"),
                   (tps.ParameterServer, "jax")):
        fresh = cls(params=np.zeros(8, np.float32), ckpt_dir=str(tmp_path / d), ckpt_every=0,
                    wal=True)
        assert fresh.maybe_restore() and fresh.replayed_updates == 4
        np.testing.assert_array_equal(fresh.central, mine.central)


def test_single_ps_worker_holds_updates_on_nack():
    """A nack makes the worker pull at once and skip its updates until the
    pulled vector is installed, then one step more (the gradients in hand
    at the install were computed on the diverged parameters)."""
    world = tmsg.InProcessTransport.create_world(2)
    model = get_model("lenet", seed=3, device="cpu")
    opt = tps.Asynchronous(model, lr=0.1, n_push=100, n_pull=100, transport=world[1])
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (4, 32, 32, 3))
                         .astype(np.float32))
    y = torch.arange(4)

    def step():
        loss_and_grads(model, x, y)
        opt.step()
        return ravel_model_params(model).clone()

    def wait(cond):
        deadline = time.monotonic() + 5
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.01)

    try:
        assert world[0].recv(timeout=1.0)[1] == tmsg.MessageCode.ParameterUpdate
        p0 = ravel_model_params(model).clone()
        p1 = step()  # idx 0: the cadence pull fires
        assert world[0].recv(timeout=1.0)[1] == tmsg.MessageCode.ParameterRequest
        assert not torch.equal(p1, p0)
        world[0].send(tmsg.MessageCode.UpdateNack, np.asarray([1.0, 5.0, 9.0], np.float32),
                      dst=1)
        wait(lambda: opt.listener._nacks_pending)
        p2 = step()
        assert opt.nacks == 1 and opt.listener.nacks == 1 and opt.skipped_updates == 1
        assert torch.equal(p2, p1)  # held: the gradients were not applied
        seen = []
        while (m := world[0].recv(timeout=0.5)) is not None:
            seen.append(m[1])
            if m[1] == tmsg.MessageCode.ParameterRequest:
                break
        assert tmsg.MessageCode.ParameterRequest in seen, seen
        central = np.full(p0.numel(), 0.25, np.float32)
        world[0].send(tmsg.MessageCode.ParameterUpdate, central, dst=1)
        wait(lambda: opt.listener._latest is not None)
        p3 = step()  # installs, still held this step
        np.testing.assert_array_equal(p3.numpy(), central)
        assert opt.skipped_updates == 2
        p4 = step()  # updates flow again
        assert not torch.equal(p4, p3) and opt.skipped_updates == 2
        # a malformed nack (too short, or a nonfinite reason) is not counted
        world[0].send(tmsg.MessageCode.UpdateNack, np.asarray([1.0], np.float32), dst=1)
        world[0].send(tmsg.MessageCode.UpdateNack,
                      np.asarray([np.nan, 0.0, 0.0], np.float32), dst=1)
        time.sleep(0.3)
        assert opt.listener.nacks == 1
    finally:
        opt._flusher.stop()
        opt.listener.stop()
