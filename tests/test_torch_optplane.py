"""The port's server-side optimizer plane (``parallel/optplane.py``) against
the JAX package's, on the same seeded numpy inputs, bit for bit:

- ``adasum`` and ``adasum_adjust`` on orthogonal, aligned, anti-aligned,
  identical, zero and random inputs;
- 20-step sgdm and adam trajectories: the applied deltas and m, v and t;
- a sharded range's step equal to the same slice of a dense step;
- ``resize`` (the overlap keeps its moments, the rest starts at zero);
- ``ps_opt.npz`` written by each package and loaded by the other, with the
  generation bound to the vector's CRC;
- the torn-window cases of the JAX ``tests/test_optplane.py``, on the
  port's server: the adopted generation after a crash between the renames,
  an orphan generation never promoted over the live one, a missing file
  resetting the moments, a restore through replay;
- ``sgdm`` with momentum 0 and lr 1 equal to no optimizer;
- the CLI face.
"""

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.parallel import optplane as jopt
from distributed_ml_pytorch_tpu_torch.parallel import optplane as topt
from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.uint32),
                                  np.asarray(b, np.float32).view(np.uint32))


def _pairs():
    rng = np.random.default_rng(0)
    a = rng.normal(size=1000).astype(np.float32)
    b = rng.normal(size=1000).astype(np.float32)
    orth = np.zeros(1000, np.float32)
    orth[1] = 1.0
    e0 = np.zeros(1000, np.float32)
    e0[0] = 1.0
    return {"random": (a, b), "aligned": (a, a + 0.3 * b), "identical": (a, a.copy()),
            "anti": (a, -a + 0.1 * b), "orthogonal": (e0, orth),
            "zero": (np.zeros(1000, np.float32), b),
            "scaled": (1e-3 * a, 1e3 * (a + b))}


def test_adasum_adjust_equals_jax_over_random_scales_and_signs():
    """The port's ``adasum_adjust`` merges in place; its bits stay the JAX
    formulation's over 200 random pairs (lengths, magnitudes 1e-5 to 1e5,
    aligned, anti-aligned) and leaves its inputs alone."""
    rng = np.random.default_rng(5)
    for trial in range(200):
        n = int(rng.integers(1, 3000))
        a = (rng.normal(size=n) * 10 ** rng.uniform(-5, 5)).astype(np.float32)
        b = (rng.normal(size=n) * 10 ** rng.uniform(-5, 5)).astype(np.float32)
        if trial % 3 == 0:
            b = (a * rng.uniform(0.5, 2.0) + 0.1 * b).astype(np.float32)
        if trial % 7 == 0:
            b = -b
        a0, b0 = a.copy(), b.copy()
        _same(topt.adasum_adjust(a, b), jopt.adasum_adjust(a, b))
        _same(a, a0)
        _same(b, b0)
    b64 = np.ones(4, np.float64)
    topt.adasum_adjust(np.ones(4, np.float32), b64)
    assert (b64 == 1.0).all()


@pytest.mark.parametrize("name", sorted(_pairs()))
def test_adasum_and_adjust_equal_jax(name):
    a, b = _pairs()[name]
    _same(topt.adasum(a, b), jopt.adasum(a, b))
    _same(topt.adasum_adjust(a, b), jopt.adasum_adjust(a, b))
    if name == "orthogonal":
        _same(topt.adasum(a, b), a + b)
    if name == "identical":
        np.testing.assert_allclose(topt.adasum(a, b), a, rtol=1e-6)


@pytest.mark.parametrize("kind,kw", [("sgdm", dict(lr=0.5, momentum=0.9)),
                                     ("sgdm", dict(lr=1.0, momentum=0.0)),
                                     ("adam", dict(lr=0.01)),
                                     ("adam", dict(lr=0.3, beta1=0.8, beta2=0.99, eps=1e-6))])
def test_20_step_trajectories_equal_jax(kind, kw):
    rng = np.random.default_rng(1)
    mine, ref = topt.ShardedOptimizer(kind, 0, 777, **kw), jopt.ShardedOptimizer(kind, 0, 777, **kw)
    for _ in range(20):
        u = rng.normal(scale=0.01, size=777).astype(np.float32)
        _same(mine.step(u), ref.step(u))
        _same(mine.m, ref.m)
        _same(mine.v, ref.v)
        assert mine.t == ref.t
    assert mine.state_floats() == ref.state_floats() == 2 * 777
    st, jst = mine.state_dict(), ref.state_dict()
    assert {k: v for k, v in st.items() if k not in "mv"} == {
        k: v for k, v in jst.items() if k not in "mv"}
    fresh = topt.ShardedOptimizer(kind, 0, 777, **kw)
    fresh.load_state_dict(jst)
    _same(fresh.m, ref.m)
    with pytest.raises(ValueError):
        topt.ShardedOptimizer(kind, 0, 10).load_state_dict(jst)


@pytest.mark.parametrize("kind", ["sgdm", "adam"])
def test_a_sharded_range_equals_the_same_slice_of_a_dense_step(kind):
    rng = np.random.default_rng(2)
    n, lo, hi = 1000, 300, 700
    dense, shard = topt.ShardedOptimizer(kind, 0, n), topt.ShardedOptimizer(kind, lo, hi)
    for _ in range(8):
        u = rng.normal(size=n).astype(np.float32)
        _same(shard.step(u[lo:hi]), dense.step(u)[lo:hi])
    _same(shard.m, dense.m[lo:hi])
    _same(shard.v, dense.v[lo:hi])
    with pytest.raises(ValueError):
        shard.step(np.zeros(n, np.float32))


def test_resize_equals_jax():
    mine, ref = topt.ShardedOptimizer("adam", 0, 8), jopt.ShardedOptimizer("adam", 0, 8)
    u = np.arange(8, dtype=np.float32)
    mine.step(u)
    ref.step(u)
    for lo, hi in ((4, 12), (4, 12), (0, 6), (10, 20)):
        mine.resize(lo, hi)
        ref.resize(lo, hi)
        assert (mine.lo, mine.hi, mine.size) == (ref.lo, ref.hi, ref.size) == (lo, hi, hi - lo)
        _same(mine.m, ref.m)
        _same(mine.v, ref.v)
    with pytest.raises(ValueError):
        mine.resize(5, 4)
    mine.reset()
    assert mine.t == 0 and not mine.m.any() and mine.m.size == 10


@pytest.mark.parametrize("writer,reader", [(topt, jopt), (jopt, topt)])
def test_state_files_load_across_the_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(3)
    w = writer.ShardedOptimizer("adam", 10, 60, lr=0.1)
    path = str(tmp_path / "ps_opt.npz")
    w.step(rng.normal(size=50).astype(np.float32))
    w.save_state(path, central_crc=111, apply_seq=1)
    m1 = w.m.copy()
    w.step(rng.normal(size=50).astype(np.float32))
    w.save_state(path, central_crc=222, apply_seq=2, prev_crc=111)
    for crc, m, t in ((222, w.m, 2), (111, m1, 1), (None, w.m, 2)):
        r = reader.ShardedOptimizer("adam", 10, 60, lr=0.1)
        assert r.load_state(path, central_crc=crc)
        _same(r.m, m)
        assert r.t == t
    with pytest.raises(ValueError):
        reader.ShardedOptimizer("adam", 10, 60).load_state(path, central_crc=333)
    with pytest.raises(ValueError):
        reader.ShardedOptimizer("adam", 0, 10).load_state(path, central_crc=222)
    assert not reader.ShardedOptimizer("adam", 0, 50).load_state(str(tmp_path / "none.npz"))
    with np.load(path) as data:
        assert int(data["prev_seq"]) == 1 and int(data["cur_seq"]) == 2


def _mk_ps(tmp_path, n=16, momentum=0.5):
    opt = topt.ShardedOptimizer("sgdm", 0, n, lr=1.0, momentum=momentum)
    return ParameterServer(params=np.zeros(n, np.float32), ckpt_dir=str(tmp_path),
                           ckpt_every=0, wal=True, optimizer=opt)


def _push_n(ps, k, n=16, seed=0, sender=1):
    rng = np.random.default_rng(seed)
    for _ in range(k):
        ps.handle(sender, MessageCode.GradientUpdate, rng.normal(size=n).astype(np.float32))


def test_state_survives_a_crash_restore_exactly(tmp_path):
    ps = _mk_ps(tmp_path)
    _push_n(ps, 3)
    ps.commit()
    ps.save_checkpoint()
    _push_n(ps, 4, seed=1)  # only in the log
    ps.commit()
    live = (ps.central.copy(), ps.optimizer.m.copy())
    ps.wal.close()
    ps2 = _mk_ps(tmp_path)
    assert ps2.maybe_restore()
    _same(ps2.central, live[0])
    _same(ps2.optimizer.m, live[1])
    assert ps2._apply_seq == 7 and ps2.replayed_updates == 4
    ps2.wal.close()


def test_a_torn_crash_pairs_the_state_with_the_adopted_generation(tmp_path):
    ps = _mk_ps(tmp_path)
    _push_n(ps, 3)
    ps.commit()
    ps.save_checkpoint()
    gen1_m = ps.optimizer.m.copy()
    _push_n(ps, 2, seed=1)
    ps.commit()
    # the crash: generation 2's state written, its meta and vector not
    ps.optimizer.save_state(ps._opt_path(), central_crc=12345, apply_seq=5)
    ps.wal.close()
    ps2 = _mk_ps(tmp_path)
    assert ps2.maybe_restore()
    assert ps2._apply_seq == 5
    rng = np.random.default_rng(1)
    expect = gen1_m.copy()
    for _ in range(2):
        expect = (0.5 * expect + rng.normal(size=16).astype(np.float32)).astype(np.float32)
    _same(ps2.optimizer.m, expect)
    ps2.wal.close()


def test_an_orphan_generation_never_evicts_the_live_one(tmp_path):
    ps = _mk_ps(tmp_path)
    _push_n(ps, 2)
    ps.commit()
    ps.save_checkpoint()
    g1_m = ps.optimizer.m.copy()
    _push_n(ps, 2, seed=1)
    ps.commit()
    ps.optimizer.save_state(ps._opt_path(), central_crc=0xDEAD, apply_seq=4, prev_crc=None)
    ps.wal.close()
    ps2 = _mk_ps(tmp_path)
    assert ps2.maybe_restore()
    _push_n(ps2, 1, seed=2)
    ps2.commit()
    ps2.save_checkpoint()
    with np.load(ps2._opt_path()) as data:
        assert int(data["prev_seq"]) == 2
        _same(data["prev_m"], g1_m)
    ps2.wal.close()


def test_a_missing_state_file_resets_the_moments(tmp_path, caplog):
    import os

    ps = _mk_ps(tmp_path)
    _push_n(ps, 2)
    ps.commit()
    ps.save_checkpoint()
    os.unlink(ps._opt_path())
    ps.wal.close()
    ps2 = _mk_ps(tmp_path)
    ps2.optimizer.m[:] = 9.0
    assert ps2.maybe_restore()
    _same(ps2.optimizer.m, np.zeros(16, np.float32))
    assert "fresh zero moments" in caplog.text
    ps2.wal.close()


def test_sgdm_momentum_0_lr_1_equals_no_optimizer():
    rng = np.random.default_rng(4)
    plain = ParameterServer(params=np.ones(50, np.float32))
    opt = ParameterServer(params=np.ones(50, np.float32),
                          optimizer=topt.ShardedOptimizer("sgdm", 0, 50, lr=1.0, momentum=0.0))
    for _ in range(10):
        u = rng.normal(size=50).astype(np.float32)
        plain.handle(1, MessageCode.GradientUpdate, u)
        opt.handle(1, MessageCode.GradientUpdate, u)
    _same(plain.central, opt.central)


def test_the_server_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="replaces"):
        ParameterServer(params=np.ones(4, np.float32), combine="adasum", staleness_damping=0.5)
    with pytest.raises(ValueError):
        ParameterServer(params=np.ones(4, np.float32), combine="mean")
    with pytest.raises(ValueError, match="covers"):
        ParameterServer(params=np.ones(4, np.float32),
                        optimizer=topt.ShardedOptimizer("sgdm", 0, 5))
    with pytest.raises(ValueError):
        topt.ShardedOptimizer("lamb", 0, 4)


def test_the_cli_face_equals_jax():
    class Args:
        server_opt = "adam"
        server_lr = 0.01
        server_momentum = 0.7

    assert topt.server_opt_from_args(Args()) == jopt.server_opt_from_args(Args())
    opt, ref = topt.optimizer_from_args(Args(), 10), jopt.optimizer_from_args(Args(), 10)
    assert (opt.kind, opt.lo, opt.hi, opt.lr, opt.momentum) == (
        ref.kind, ref.lo, ref.hi, ref.lr, ref.momentum)
    Args.server_opt = "none"
    assert topt.optimizer_from_args(Args(), 10) is None
    assert topt.OPT_KINDS == jopt.OPT_KINDS
