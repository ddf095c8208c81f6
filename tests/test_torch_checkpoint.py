"""The port's checkpointer (``utils/checkpoint.py``) against the JAX one.

The same sequence of offered saves goes to the JAX ``Checkpointer`` (orbax)
and to the port's: the same saves are accepted (``force`` or ``step %
save_interval_steps == 0``; an existing step is a no-op) and the same steps
are retained (the newest ``max_to_keep``). ``resume_position`` gives the
same ``(epoch, iter)``. A round trip restores parameters, optimizer state
(device counters included), step and generator state bit for bit, in place.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.utils import checkpoint as jck
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
from distributed_ml_pytorch_tpu_torch.utils import checkpoint as tck

#: (step, force) offers: interval saves, repeats, a forced off-interval save
OFFERS = [(0, False), (1, False), (3, False), (3, False), (4, True), (5, False), (6, False),
          (7, False), (9, False), (10, True), (12, False), (12, True)]


def _state(seed=0):
    model = get_model("lenet", seed=seed, device="cpu")
    tx = ttr.build_tx("adamw", 0.01, grad_accum=2)
    return ttr.create_train_state(model, tx, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("interval,keep", [(3, 2), (1, 3), (5, 1)])
def test_acceptance_and_retention_follow_orbax(tmp_path, interval, keep):
    jc = jck.Checkpointer(str(tmp_path / "jax"), max_to_keep=keep, save_interval_steps=interval)
    tc = tck.Checkpointer(str(tmp_path / "port"), max_to_keep=keep,
                          save_interval_steps=interval)
    tree = {"w": jnp.zeros(3)}
    state = _state()
    for step, force in OFFERS:
        want = jc.save(step, tree, force=force)
        jc.wait()
        state.step = step
        assert tc.save(step, state, force=force) == want, (step, force)
        tc.wait()
    jc.close()
    tc.close()
    assert tc.all_steps() == sorted(jck.Checkpointer(str(tmp_path / "jax"))._mgr.all_steps())
    assert tc.latest_step() == max(tc.all_steps())
    assert not [f for d in os.listdir(tc.directory)
                for f in os.listdir(os.path.join(tc.directory, d)) if f.endswith(".tmp")]


@pytest.mark.parametrize("step,spe", [(0, 5), (4, 5), (5, 5), (17, 5), (100, 7)])
def test_resume_position_matches_jax(step, spe):
    assert tck.resume_position(step, spe) == jck.resume_position(step, spe)


def test_resume_position_refuses_a_bad_epoch():
    with pytest.raises(ValueError):
        tck.resume_position(3, 0)


@pytest.mark.parametrize("background", [True, False])
def test_round_trip_restores_everything_in_place(tmp_path, background):
    state = _state(1)
    tx = ttr.build_tx("adamw", 0.01, grad_accum=2)
    step = ttr.make_train_step(state.model, tx)
    state.opt_state = tx.init(list(state.model.parameters()))
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.uniform(-1, 1, size=(4, 32, 32, 3)).astype(np.float32)
        state, _ = step(state, x, np.arange(4))
    ck = tck.Checkpointer(str(tmp_path), save_interval_steps=3, background=background)
    assert ck.save(state.step, state)
    ck.wait()
    saved = ([p.clone() for p in state.model.parameters()],
             [t.clone() for t in state.opt_state.tensors()], state.generator.get_state())

    fresh = _state(2)
    fresh.opt_state = tx.init(list(fresh.model.parameters()))
    ptrs = [t.data_ptr() for t in [*fresh.model.parameters(), *fresh.opt_state.tensors()]]
    restored, at = tck.maybe_restore(ck, fresh)
    assert at == 3 and restored is fresh and fresh.step == 3
    assert [t.data_ptr() for t in [*fresh.model.parameters(),
                                   *fresh.opt_state.tensors()]] == ptrs
    for a, b in zip(fresh.model.parameters(), saved[0]):
        assert torch.equal(a, b)
    for a, b in zip(fresh.opt_state.tensors(), saved[1]):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert int(fresh.opt_state.count) == 1 and int(fresh.opt_state.mini_step) == 1
    assert torch.equal(fresh.generator.get_state(), saved[2])


def test_maybe_restore_without_checkpoints(tmp_path):
    state = _state()
    assert tck.maybe_restore(None, state) == (state, 0)
    ck = tck.Checkpointer(str(tmp_path))
    assert tck.maybe_restore(ck, state) == (state, 0)
    with pytest.raises(FileNotFoundError):
        ck.restore(state)
