"""The port's optimizer layer (``training/optim.py``) against the optax chain
the JAX trainer builds (``make_lr_schedule``, ``build_tx``, ``tx_from_args``).

The same seeded parameters and six steps of seeded gradients go through both;
the parameters and updates are compared after every step. Tolerance: rtol
1e-6, atol 1e-7 — the same float32 operations in the same order (optax runs
eagerly here, one op at a time, so XLA fuses nothing into an FMA); pow, cos
and sqrt may differ in their last bit between the two libraries. With
``grad_accum`` the non-final micro-steps' updates are exactly zero on both
sides.
"""

from argparse import Namespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_ml_pytorch_tpu.training import trainer as jtr
from distributed_ml_pytorch_tpu_torch.training import optim as top

SHAPES = [(3, 4), (5,), (2, 3, 2)]
STEPS = 6
TOL = dict(rtol=1e-6, atol=1e-7)


def _seeded(seed):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) * 2.0 for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _run_both(jtx, ttx, seed=0):
    """Six updates through both; per step ``(jax params, port params, jax
    updates, port updates)`` as numpy."""
    params, grads = _seeded(seed)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = ttx.init(tp)
    out = []
    for g in grads:
        ju, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu = ttx.update([torch.from_numpy(x) for x in g], tstate, tp)
        with torch.no_grad():
            for p, u in zip(tp, tu):
                p.add_(u)
        out.append(([np.asarray(x) for x in jp], [p.numpy().copy() for p in tp],
                     [np.asarray(x) for x in ju], [u.numpy() for u in tu]))
    return out


def _assert_close(out):
    for jp, tp, ju, tu in out:
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a, b, **TOL)
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a, b, **TOL)


CASES = {
    "sgd": dict(optimizer="sgd"),
    "sgd_momentum": dict(optimizer="sgd", momentum=0.9),
    "sgd_l2_clip": dict(optimizer="sgd", momentum=0.9, weight_decay=0.01, grad_clip=0.5),
    "adam": dict(optimizer="adam"),
    "adam_l2_clip": dict(optimizer="adam", weight_decay=0.01, grad_clip=0.5),
    "adamw_default_decay": dict(optimizer="adamw"),
    "adamw_no_decay": dict(optimizer="adamw", weight_decay=0.0),
    "adamw_decay_clip": dict(optimizer="adamw", weight_decay=0.05, grad_clip=1.0),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("schedule", ["constant", "inverse-epoch", "cosine"])
def test_build_tx_matches_optax(case, schedule):
    kw = CASES[case]
    lr = 0.05 if kw["optimizer"] == "sgd" else 0.01
    jlr = jtr.make_lr_schedule(schedule, lr, steps_per_epoch=2, total_epochs=2)
    tlr = top.make_lr_schedule(schedule, lr, steps_per_epoch=2, total_epochs=2)
    _assert_close(_run_both(jtr.build_tx(lr=jlr, **kw), top.build_tx(lr=tlr, **kw)))


@pytest.mark.parametrize("case", ["sgd_momentum", "adamw_decay_clip"])
def test_grad_accum_is_multisteps(case):
    """grad_accum=4: zero updates on micro-steps 1-3 (both sides), the
    Welford mean and one inner update on the 4th, the schedule advancing
    per update (cosine over 2 updates an epoch)."""
    kw = dict(CASES[case], grad_accum=4)
    jlr = jtr.make_lr_schedule("cosine", 0.05, steps_per_epoch=1, total_epochs=2)
    tlr = top.make_lr_schedule("cosine", 0.05, steps_per_epoch=1, total_epochs=2)
    out = _run_both(jtr.build_tx(lr=jlr, **kw), top.build_tx(lr=tlr, **kw))
    _assert_close(out)
    for step, (_jp, _tp, ju, tu) in enumerate(out):
        final = step % 4 == 3
        assert all(np.any(u != 0) == final for u in tu), step
        assert all(np.any(u != 0) == final for u in ju), step


def test_multisteps_state_counts_and_welford_mean():
    """The inner count moves only on the k-th micro-step; the accumulator
    is the running mean acc + (g - acc)/(n + 1), then reset to zero."""
    tx = top.build_tx("sgd", 1.0, grad_accum=3)
    p = [torch.zeros(4)]
    state = tx.init(p)
    gs = [torch.full((4,), v) for v in (1.0, 2.0, 6.0)]
    acc = torch.zeros(4)
    for n, g in enumerate(gs):
        u = tx.update([g], state, p)[0]
        acc = acc + (g - acc) / (n + 1)
        if n < 2:
            assert torch.equal(u, torch.zeros(4)) and int(state.inner.count) == 0
            assert torch.equal(state.slots["acc"][0], acc)
    assert torch.equal(u, -acc) and float(acc[0]) == 3.0
    assert int(state.inner.count) == 1 and int(state.count) == 1 and int(state.mini_step) == 0
    assert torch.equal(state.slots["acc"][0], torch.zeros(4))


@pytest.mark.parametrize("schedule", ["inverse-epoch", "cosine"])
def test_schedules_match_optax_at_each_count(schedule):
    jlr = jtr.make_lr_schedule(schedule, 0.1, steps_per_epoch=3, total_epochs=4)
    tlr = top.make_lr_schedule(schedule, 0.1, steps_per_epoch=3, total_epochs=4)
    for count in range(15):  # past the cosine's 12 decay steps: it stays at 0
        ref = np.float32(jlr(jnp.asarray(count, jnp.int32)))
        got = tlr(torch.tensor(count, dtype=torch.int32)).numpy()
        np.testing.assert_allclose(got, ref, **TOL)
    assert top.make_lr_schedule("constant", 0.1) == jtr.make_lr_schedule("constant", 0.1)
    with pytest.raises(ValueError):
        top.make_lr_schedule("step", 0.1)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_tx_from_args_matches_jax(grad_accum):
    """The CLI path: the schedule's epoch counts optimizer updates (raw
    batches // grad_accum) on both sides."""
    args = Namespace(lr=0.05, epochs=2, optimizer="adamw", momentum=0.0, weight_decay=0.01,
                     grad_clip=1.0, lr_schedule="inverse-epoch", grad_accum=grad_accum)
    _assert_close(_run_both(jtr.tx_from_args(args, 4), top.tx_from_args(args, 4), seed=1))


def test_optimizer_state_is_on_the_parameters_device_and_counts():
    tx = top.make_optimizer("adam", top.make_lr_schedule("cosine", 0.1, 2, 2))
    p = [torch.ones(3)]
    state = tx.init(p)
    assert state.count.dtype == torch.int32 and len(state) == 1
    for _ in range(3):
        tx.update([torch.ones(3)], state, p)
    assert int(state.count) == 3
    sgd = top.SGD(0.1)
    assert len(sgd.init(p)) == 0 and len(top.SGD(0.1, momentum=0.9).init(p)) == 1
    with pytest.raises(ValueError, match="needs the parameters"):
        top.make_optimizer("adamw", 0.1).update([torch.ones(3)], tx.init(p))
    with pytest.raises(ValueError):
        top.make_optimizer("lamb", 0.1)


def test_clip_by_global_norm_matches_optax():
    _params, grads = _seeded(3)
    g = grads[0]
    for max_norm in (0.1, 1e3):
        ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(x) for x in g], None)
        got = top.clip_by_global_norm([torch.from_numpy(x) for x in g], max_norm)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_opt_state_round_trips_in_place():
    tx = top.build_tx("adamw", 0.1, grad_accum=2)
    p = [torch.ones(2, 3)]
    state = tx.init(p)
    for _ in range(3):
        tx.update([torch.randn(2, 3)], state, p)
    saved = {k: v for k, v in state.state_dict().items()}
    snapshot = [t.clone() for t in state.tensors()]
    fresh = tx.init(p)
    storages = [t.data_ptr() for t in fresh.tensors()]
    fresh.load_state_dict(saved)
    assert [t.data_ptr() for t in fresh.tensors()] == storages
    for a, b in zip(fresh.tensors(), snapshot):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="layout"):
        top.build_tx("sgd", 0.1).init(p).load_state_dict(saved)

