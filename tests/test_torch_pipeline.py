"""Pipeline parallelism (``parallel/pipeline.py``) of the port on worlds of
threads, case for case as the JAX package's ``tests/test_pipeline.py``.

The JAX side: ``make_pp_train_step`` on a one-stage mesh (the plain
sequential forward, which every schedule must equal) and, for the
interleaved schedule with its wrap FIFO, on two stages; the weights carried
across with ``utils/interop.pp_params_from_jax``. The port runs GPipe, 1F1B
and interleaved over ``stage`` ranks, with dp and tp. Bounds are the JAX
test's: the pipeline against the single stage, losses rtol 2e-5 and
parameters rtol 3e-5 / atol 1e-6; interleaved against GPipe rtol 1e-5 and
2e-4 / 1e-5; 1F1B against GPipe rtol 1e-6 and 1e-6 / 1e-8 (the same units
in another order: equal here bit for bit); dp × pp against pure pp loss
within 1e-5 and parameters 1e-5 / 1e-6; pp × tp (and dp × pp × tp on
2 × 2 × 2) within 1e-5 and 3e-5 / 1e-6 (the row-parallel sums add the
ranks' partial products in another order).
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from distributed_ml_pytorch_tpu.parallel import pipeline as jpp
from distributed_ml_pytorch_tpu.parallel.seq_parallel import next_token_targets
from distributed_ml_pytorch_tpu_torch.parallel import pipeline as pp
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
from distributed_ml_pytorch_tpu_torch.utils import interop

CFG4 = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_len=128)
CFG8 = dict(CFG4, n_layers=8)
LR = 0.1


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_batch(batch=8, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, size=(batch, seq)).astype(np.int32)
    return tokens, next_token_targets(tokens)


def _jax_pp(cfg, tmb, gmb, n_stages=1, steps=1, seed=0, **kw):
    """The JAX step on ``n_stages``: initial params (the port's whole
    ``state_dict``), losses and the final params (likewise); ``kw`` as
    ``make_pp_train_step``'s (an interleaved run's blocks in storage
    order)."""
    jcfg = jpp.PipelineLMConfig(**cfg)
    mesh = Mesh(np.array(jax.devices()[:n_stages]), ("stage",))
    tx = optax.sgd(LR)
    state = jpp.create_pp_train_state(jcfg, jax.random.key(seed), tx, mesh)
    if kw.get("schedule") == "interleaved":
        order = jpp.interleave_layer_order(cfg["n_layers"], n_stages, kw["virtual_stages"])
        state = state.replace(params={**state.params, "blocks": jax.tree.map(
            lambda x: x[order], state.params["blocks"])})
    init = interop.pp_params_from_jax(jax.tree.map(np.asarray, jax.device_get(state.params)))
    step = jpp.make_pp_train_step(jcfg, tx, mesh, n_microbatches=tmb.shape[0], **kw)
    losses = []
    for _ in range(steps):
        state, loss = step(state, tmb, gmb)
        losses.append(float(loss))
    final = interop.pp_params_from_jax(jax.tree.map(np.asarray, jax.device_get(state.params)))
    return init, losses, final


def _world(cfg, shape, params, tmb, gmb, steps=1, schedule="gpipe", tx=None, **kw):
    """A port world of ``shape``: per rank ``(losses, local state dict,
    mesh coords, peak stash, optimizer state)``."""
    pcfg = pp.PipelineLMConfig(**cfg)
    model_axis = "model" if "model" in shape else None
    data_axis = "data" if "data" in shape else None

    def rank(world):
        mesh = make_mesh(shape, world=world)
        opt = tx() if tx is not None else SGD(LR)
        state = pp.create_pp_train_state(pcfg, opt, mesh, model_axis=model_axis,
                                         params=params)
        step = pp.make_pp_train_step(pcfg, opt, mesh, tmb.shape[0], schedule=schedule,
                                     data_axis=data_axis, model_axis=model_axis, **kw)
        losses = [float(step(state, tmb, gmb)[1]) for _ in range(steps)]
        return (losses, {n: p.detach().clone() for n, p in state.model.named_parameters()},
                mesh.coords, state.peak_stash, state.opt_state)

    n = int(np.prod(list(shape.values())))
    return run_threaded(n, rank)


def _full(out, cfg, n_stages):
    """The whole model's parameters from a pure-pp world's stage ranks."""
    per = cfg["n_layers"] // n_stages
    full = {}
    for _losses, local, coords, _peak, _opt in out:
        s = coords["stage"]
        for name, t in local.items():
            if name.startswith("blocks."):
                _, i, rest = name.split(".", 2)
                full[f"blocks.{s * per + int(i)}.{rest}"] = t
            else:
                full[name] = t
    return full


def _close_params(got, want, **tol):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), err_msg=name, **tol)


@pytest.fixture(scope="module")
def single_stage():
    """The JAX one-stage reference of cfg4 on batch 8 × 16, two steps."""
    tokens, targets = make_batch()
    t1, g1 = jpp.microbatch(tokens, targets, 1)
    return _jax_pp(CFG4, t1, g1, steps=2)


def test_pipeline_matches_single_stage(single_stage):
    """The 4-stage pipeline equals the single-stage step: loss and updated
    parameters."""
    init, ref_losses, ref_final = single_stage
    tmb, gmb = pp.microbatch(*make_batch(), 4)
    out = _world(CFG4, {"stage": 4}, init, tmb, gmb, steps=2)
    for losses, *_ in out:
        np.testing.assert_allclose(losses, ref_losses, rtol=2e-5)
    _close_params(_full(out, CFG4, 4), ref_final, rtol=3e-5, atol=1e-6)


def test_pipeline_microbatch_count_does_not_change_loss(single_stage):
    init = single_stage[0]
    tokens, targets = make_batch()
    l2 = _world(CFG4, {"stage": 2}, init, *pp.microbatch(tokens, targets, 2))[0][0]
    l8 = _world(CFG4, {"stage": 2}, init, *pp.microbatch(tokens, targets, 8))[0][0]
    np.testing.assert_allclose(l2, l8, rtol=2e-5)


def test_pp_state_blocks_sharded_over_stages():
    """Each of 4 stages holds one of the 4 layers; the momentum mirrors the
    local parameters; the replicated pieces stay whole."""
    tmb, gmb = pp.microbatch(*make_batch(), 4)
    out = _world(CFG4, {"stage": 4}, None, tmb, gmb,
                 tx=lambda: SGD(LR, momentum=0.9))
    for _losses, local, _c, _p, opt in out:
        assert sorted({n.split(".")[1] for n in local if n.startswith("blocks.")}) == ["0"]
        assert [tuple(t.shape) for t in opt.slots["trace"]] == [tuple(t.shape)
                                                               for t in local.values()]
        assert tuple(local["head.weight"].shape) == (64, 32)


def test_pp_rejects_indivisible_layers():
    def rank(world):
        pp.create_pp_train_state(pp.PipelineLMConfig(n_layers=3), SGD(LR),
                                 make_mesh({"stage": 2}, world=world))

    with pytest.raises(ValueError, match="divide evenly"):
        run_threaded(2, rank)


def test_microbatch_rejects_indivisible_batch():
    tokens, targets = make_batch(batch=6)
    with pytest.raises(ValueError, match="microbatches"):
        pp.microbatch(tokens, targets, 4)


def test_pp_params_round_trip_through_the_jax_tree():
    tree = jax.tree.map(np.asarray, jpp.init_pp_params(jpp.PipelineLMConfig(**CFG4),
                                                       jax.random.key(3)))
    back = interop.pp_params_to_jax(interop.pp_params_from_jax(tree))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_interleaved_schedule_matches_gpipe_loss_and_grads():
    """Interleaved (S=4, v=2, 8 layers) computes GPipe's function: the same
    loss, and the same update under the storage permutation; both equal
    the JAX one-stage step."""
    tokens, targets = make_batch(batch=8, seq=16)
    tmb, gmb = pp.microbatch(tokens, targets, 4)
    init, jl, jfinal = _jax_pp(CFG8, *jpp.microbatch(tokens, targets, 1))
    order = pp.interleave_layer_order(8, 4, 2)
    g = _world(CFG8, {"stage": 4}, init, tmb, gmb)
    i = _world(CFG8, {"stage": 4}, pp.permute_blocks(init, order), tmb, gmb,
               schedule="interleaved", virtual_stages=2)
    np.testing.assert_allclose(i[0][0], g[0][0], rtol=1e-5)
    np.testing.assert_allclose(g[0][0], jl, rtol=2e-5)
    _close_params(_full(i, CFG8, 4), pp.permute_blocks(_full(g, CFG8, 4), order),
                  rtol=2e-4, atol=1e-5)
    _close_params(_full(g, CFG8, 4), jfinal, rtol=3e-5, atol=1e-6)


def test_interleaved_schedule_wrap_fifo_depths():
    """M > S exercises the wrap FIFO (a wrapped activation waits M - S = 4
    ticks on stage 0), M == S the direct hand-off; both equal GPipe, and
    M = 6 equals the JAX interleaved step on two stages."""
    S, v = 2, 2
    order = pp.interleave_layer_order(4, S, v)
    for M in (2, 6):
        first = {(k, r, m): t for t, k, r, m in pp.stage_timetable("interleaved", 0, S, M, v)}
        last = {(k, r, m): t for t, k, r, m in pp.stage_timetable("interleaved", S - 1, S, M,
                                                                   v)}
        assert {first[("F", 1, m)] - last[("F", 0, m)] - 1 for m in range(M)} == {M - S}
        tmb, gmb = pp.microbatch(*make_batch(batch=M * 2, seq=16, seed=M), M)
        if M == 6:
            init, jl, _ = _jax_pp(CFG4, tmb, gmb, n_stages=S, seed=1, schedule="interleaved",
                                  virtual_stages=v)
            init = pp.permute_blocks(init, np.argsort(order))  # back to model order
        else:
            init, jl, _ = _jax_pp(CFG4, *jpp.microbatch(*make_batch(M * 2, 16, M), 1), seed=1)
        g = _world(CFG4, {"stage": S}, init, tmb, gmb)[0][0]
        i = _world(CFG4, {"stage": S}, pp.permute_blocks(init, order), tmb, gmb,
                   schedule="interleaved", virtual_stages=v)[0][0]
        np.testing.assert_allclose(i, g, rtol=1e-5)
        np.testing.assert_allclose(i, jl, rtol=2e-5)


def test_interleaved_rejects_too_few_microbatches():
    def rank(world):
        pp.make_pp_train_step(pp.PipelineLMConfig(**CFG8), SGD(LR),
                              make_mesh({"stage": 4}, world=world), 2,
                              schedule="interleaved", virtual_stages=2)

    with pytest.raises(ValueError, match="n_microbatches >= n_stages"):
        run_threaded(4, rank)


def test_1f1b_schedule_timetable_properties():
    """The JAX test's structural proof on the port's ``oneF1B_tick_roles``
    (equal to the JAX function at every tick and stage): every microbatch
    runs F then B once per stage, a stage never does two units in a tick,
    backward hand-offs arrive one tick after their producer, and the S-slot
    arrivals ring is never overwritten while live (at most S parked)."""
    for S, M in [(2, 4), (4, 8), (4, 4), (3, 7), (4, 2), (1, 3)]:
        T = 2 * (M + S - 1)
        F, B = {}, {}
        for s in range(S):
            ring, peak = {}, 0
            for t in range(T):
                m_f, m_b = pp.oneF1B_tick_roles(t, s, S, M)
                assert (m_f, m_b) == tuple(int(x) for x in jpp.oneF1B_tick_roles(t, s, S, M))
                assert not (m_f >= 0 and m_b >= 0), (S, M, s, t)
                if s > 0:
                    m_a, _ = pp.oneF1B_tick_roles(t - 1, s - 1, S, M)
                    if m_a >= 0:
                        assert ring.get(m_a % S) is None, "overwrote live slot"
                        ring[m_a % S] = m_a
                        peak = max(peak, sum(x is not None for x in ring.values()))
                if m_f >= 0:
                    assert (s, m_f) not in F
                    F[(s, m_f)] = t
                    if s > 0:
                        assert ring.get(m_f % S) == m_f
                if m_b >= 0:
                    assert (s, m_b) not in B
                    B[(s, m_b)] = t
                    if s > 0:
                        assert ring.get(m_b % S) == m_b
                        ring[m_b % S] = None
            if s > 0:
                assert 1 <= peak <= min(S, M), (S, M, s, peak)
        for s in range(S):
            for m in range(M):
                assert B[(s, m)] > F[(s, m)]
                if s > 0:
                    assert F[(s, m)] >= F[(s - 1, m)] + 1
                if s < S - 1:
                    assert B[(s, m)] == B[(s + 1, m)] + 1
        assert max(B.values()) == T - 1
        # the port's per-stage unit lists follow the same timetable
        for s in range(S):
            units = pp.stage_timetable("1f1b", s, S, M)
            assert [(t, k, m) for t, k, _r, m in units] == sorted(
                [(F[(s, m)], "F", m) for m in range(M)]
                + [(B[(s, m)], "B", m) for m in range(M)])


def test_1f1b_matches_gpipe_loss_and_grads(single_stage):
    """1F1B and GPipe compute the same function (4 stages, 4 microbatches):
    equal loss and updates; a 1F1B stage keeps at most S - s microbatch
    graphs, GPipe all M."""
    init = single_stage[0]
    tmb, gmb = pp.microbatch(*make_batch(), 4)
    g = _world(CFG4, {"stage": 4}, init, tmb, gmb)
    f = _world(CFG4, {"stage": 4}, init, tmb, gmb, schedule="1f1b")
    np.testing.assert_allclose(f[0][0], g[0][0], rtol=1e-6)
    _close_params(_full(f, CFG4, 4), _full(g, CFG4, 4), rtol=1e-6, atol=1e-8)
    assert [r[3] for r in g] == [4, 4, 4, 4]
    assert [r[3] for r in sorted(f, key=lambda r: r[2]["stage"])] == [4, 3, 2, 1]


def test_1f1b_m_equals_s_and_m_less_than_s():
    """Edge cadences: M == S and M < S (all warm-up) still match GPipe."""
    cfg = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=4, d_ff=32, max_len=64)
    for M in (4, 2):
        tokens, targets = make_batch(batch=M * 2, seq=8)
        tokens, targets = tokens % 32, targets % 32
        tmb, gmb = pp.microbatch(tokens, targets, M)
        g = _world(cfg, {"stage": 4}, None, tmb, gmb)[0][0]
        f = _world(cfg, {"stage": 4}, None, tmb, gmb, schedule="1f1b")[0][0]
        np.testing.assert_allclose(f, g, rtol=1e-5)


def _composite_batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(4, 8, 16)).astype(np.int32)
    targets = rng.integers(0, 64, size=(4, 8, 16)).astype(np.int32)
    return tokens, targets


@pytest.fixture(scope="module")
def pure_pp():
    """JAX pure pp's function on the composite batch (the one-stage step
    over the same 4 microbatches: every schedule equals it) and the port's
    2-stage GPipe on it."""
    cfg = dict(CFG4, max_len=64)
    tmb, gmb = _composite_batch()
    init, jl, jfinal = _jax_pp(cfg, tmb, gmb)
    return cfg, init, jl, jfinal


SCHEDS = [("gpipe", {}), ("interleaved", {"virtual_stages": 2}), ("1f1b", {})]


def _storage(init, sched, kw, n_stages=2):
    if sched != "interleaved":
        return init, None
    order = pp.interleave_layer_order(4, n_stages, kw["virtual_stages"])
    return pp.permute_blocks(init, order), order


@pytest.mark.parametrize("sched,kw", SCHEDS)
def test_dp_pp_composite_matches_pure_pp(pure_pp, sched, kw):
    """dp × pp on (data=2, stage=2) equals pure pp on the same global batch
    (loss and updated parameters), for every schedule: the rows split over
    data, the gradients averaged over it."""
    cfg, init, jl, jfinal = pure_pp
    tmb, gmb = _composite_batch()
    params, order = _storage(init, sched, kw)
    out = _world(cfg, {"data": 2, "stage": 2}, params, tmb, gmb, schedule=sched, **kw)
    for losses, *_ in out:
        assert abs(losses[0] - jl[0]) < 1e-5
    rows = [r for r in out if r[2]["data"] == 0]
    full = _full(rows, cfg, 2)
    if order is not None:
        full = pp.permute_blocks(full, np.argsort(order))
    _close_params(full, jfinal, rtol=1e-5, atol=1e-6)
    other = _full([r for r in out if r[2]["data"] == 1], cfg, 2)
    for name, t in _full(rows, cfg, 2).items():
        assert torch.equal(t, other[name]), name


def _tp_check(out, cfg, jfinal, order=None):
    """Every rank's local (tp-sharded) blocks against the slices of the
    pure-pp result; the replicated pieces whole."""
    names = list(jfinal)
    specs = pp.pp_param_specs({n: jfinal[n] for n in names}, "stage", "model")
    per = cfg["n_layers"] // 2
    want_full = jfinal if order is None else pp.permute_blocks(jfinal, order)
    for _losses, local, coords, _p, _o in out:
        s, m = coords["stage"], coords["model"]
        for name, t in local.items():
            if name.startswith("blocks."):
                _, i, rest = name.split(".", 2)
                gname = f"blocks.{s * per + int(i)}.{rest}"
            else:
                gname = name
            w = want_full[gname]
            spec = specs[gname]
            if "model" in spec:
                w = w.chunk(2, dim=spec.index("model") - 1)[m]
            np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=3e-5, atol=1e-6,
                                       err_msg=f"{gname} stage {s} model {m}")


@pytest.mark.parametrize("sched,kw", SCHEDS)
def test_pp_tp_composite_matches_pure_pp(pure_pp, sched, kw):
    """pp × tp on (stage=2, model=2): the Megatron block inside each stage
    equals pure pp running the same schedule."""
    cfg, init, jl, jfinal = pure_pp
    tmb, gmb = _composite_batch()
    params, order = _storage(init, sched, kw)
    out = _world(cfg, {"stage": 2, "model": 2}, params, tmb, gmb, schedule=sched, **kw)
    for losses, *_ in out:
        assert abs(losses[0] - jl[0]) < 1e-5
    _tp_check(out, cfg, jfinal, order)


def test_dp_pp_tp_2x2x2_matches_pure_pp(pure_pp):
    """The full composite: dp × pp × tp on (data=2, stage=2, model=2)."""
    cfg, init, jl, jfinal = pure_pp
    tmb, gmb = _composite_batch()
    out = _world(cfg, {"data": 2, "stage": 2, "model": 2}, init, tmb, gmb)
    for losses, *_ in out:
        assert abs(losses[0] - jl[0]) < 1e-5
    _tp_check(out, cfg, jfinal)


def test_pp_tp_state_megatron_sharded():
    """pp × tp state: q/k/v and Dense_0 (with its bias) hold half their
    output rows, o and Dense_1 half their input columns, within the stage's
    layers; Dense_1's bias and the LNs whole; the momentum mirrors them; the
    spec function gives the same rules."""
    cfg = dict(CFG4, max_len=64)
    tmb, gmb = _composite_batch()
    out = _world(cfg, {"stage": 2, "model": 2}, None, tmb, gmb,
                 tx=lambda: SGD(LR, momentum=0.9))
    _l, local, _c, _p, opt = out[0]
    shapes = {n: tuple(t.shape) for n, t in local.items()}
    assert shapes["blocks.0.attn.q.weight"] == (16, 32)
    assert shapes["blocks.0.attn.o.weight"] == (32, 16)
    assert shapes["blocks.0.Dense_0.weight"] == (32, 32)
    assert shapes["blocks.0.Dense_0.bias"] == (32,)
    assert shapes["blocks.0.Dense_1.weight"] == (32, 32)
    assert shapes["blocks.0.Dense_1.bias"] == (32,)
    assert shapes["blocks.0.LayerNorm_0.weight"] == (32,)
    assert shapes["head.weight"] == (64, 32)
    assert [tuple(t.shape) for t in opt.slots["trace"]] == list(shapes.values())
    full = pp.init_pp_params(pp.PipelineLMConfig(**cfg))
    specs = pp.pp_param_specs(full, "stage", "model")
    assert specs["blocks.0.attn.v.weight"] == ("stage", "model", None)
    assert specs["blocks.0.attn.o.weight"] == ("stage", None, "model")
    assert specs["blocks.0.Dense_0.bias"] == ("stage", "model")
    assert specs["blocks.0.Dense_1.bias"] == ("stage", None)
    assert specs["head.weight"] == ()


def test_pp_tp_rejects_indivisible_dims():
    cfg = pp.PipelineLMConfig(vocab_size=64, d_model=30, n_heads=3, n_layers=4, d_ff=64,
                              max_len=64)
    errors = []

    def rank(world):
        mesh = make_mesh({"stage": 2, "model": 2}, world=world)
        for fn in (lambda: pp.create_pp_train_state(cfg, SGD(LR), mesh, model_axis="model"),
                   lambda: pp.make_pp_train_step(cfg, SGD(LR), mesh, 2, model_axis="model")):
            try:
                fn()
            except ValueError as e:
                errors.append(str(e))
        smesh = make_mesh({"stage": 4}, world=world)
        try:
            pp.make_pp_train_step(pp.PipelineLMConfig(n_layers=4), SGD(LR), smesh, 2,
                                  model_axis="model")
        except ValueError as e:
            errors.append(str(e))

    run_threaded(4, rank)
    assert len(errors) == 12
    assert sum("n_heads" in e for e in errors) == 8
    assert sum("model_axis" in e for e in errors) == 4


def test_dp_pp_rejects_unknown_data_axis():
    def rank(world):
        pp.make_pp_train_step(pp.PipelineLMConfig(**dict(CFG4, n_layers=2)), SGD(LR),
                              make_mesh({"stage": 2}, world=world), 2, data_axis="data")

    with pytest.raises(ValueError, match="data_axis"):
        run_threaded(2, rank)
