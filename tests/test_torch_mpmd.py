"""The MPMD pipeline plane's pieces (``parallel/mpmd.py``, ``coord/stages.py``)
on the CPU against the JAX package's, case for case as the JAX
``tests/test_mpmd.py``'s unit tests.

The JAX side is computed once for the module (``jax_ref``): the JAX
``MpmdLocal`` at ``cfg4`` (4 stages, 4 microbatches of 2 x 16) for two steps
in both schedules, from ``init_pp_params(cfg4, key(0))``, whose weights the
port takes through ``utils/interop.pp_params_from_jax``. Bounds: the port's
``MpmdLocal`` against the JAX one, losses rtol 1e-5 and parameters rtol 3e-5
/ atol 1e-6 (the JAX test's bound between its pipeline and one stage);
against the port's one-stage reference the same; 1F1B against GPipe rtol
1e-6 (the same units in another order). ``stage_param_ranges`` equals
JAX's exactly, and the wire's placements, stage-ready frames and stage
checkpoints are read by the other package byte for byte.
"""

import os

import jax
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.coord import stages as jst
from distributed_ml_pytorch_tpu.parallel import mpmd as jmpmd
from distributed_ml_pytorch_tpu.parallel import pipeline as jpp
from distributed_ml_pytorch_tpu.parallel.seq_parallel import next_token_targets
from distributed_ml_pytorch_tpu_torch.coord import coordinator as tco
from distributed_ml_pytorch_tpu_torch.coord import stages as tst
from distributed_ml_pytorch_tpu_torch.coord.manifest import (
    FleetManifest,
    ManifestError,
    ShardRecord,
)
from distributed_ml_pytorch_tpu_torch.parallel import mpmd
from distributed_ml_pytorch_tpu_torch.parallel.pipeline import PipelineLMConfig
from distributed_ml_pytorch_tpu_torch.utils import interop
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    InProcessTransport,
    MessageCode,
    _split16,
)

CFG4 = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_len=128)
LR = 0.1


def small_cfg(n_stages=4, seq=8):
    return dict(vocab_size=32, d_model=16, n_heads=2, n_layers=n_stages, d_ff=32,
                max_len=max(64, seq))


def make_batch(batch=8, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, size=(batch, seq)).astype(np.int32)
    return tokens, np.asarray(next_token_targets(tokens))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX ``MpmdLocal`` at ``cfg4``: its initial weights (the port's
    whole ``state_dict``), two steps' losses and final weights, GPipe and
    1F1B."""
    cfg = jpp.PipelineLMConfig(**CFG4)
    tokens, targets = make_batch()
    tmb, gmb = tokens.reshape(4, 2, 16), targets.reshape(4, 2, 16)
    out = {"init": interop.pp_params_from_jax(_np_tree(jpp.init_pp_params(
        cfg, jax.random.key(0))))}
    for schedule in ("gpipe", "1f1b"):
        local = jmpmd.MpmdLocal(cfg, 4, 4, LR, jax.random.key(0), schedule=schedule)
        out[schedule] = [local.step(tmb, gmb) for _ in range(2)]
        out[schedule + "_final"] = interop.pp_params_from_jax(_np_tree(local.full_params()))
    return out


def _port_local(n_stages, n_micro, params, schedule="gpipe", steps=2):
    tokens, targets = make_batch()
    local = mpmd.MpmdLocal(PipelineLMConfig(**CFG4), n_stages, n_micro, LR,
                           schedule=schedule, params=params, device="cpu")
    shape = (n_micro, 8 // n_micro, 16)
    losses = [local.step(tokens.reshape(shape), targets.reshape(shape)) for _ in range(steps)]
    return losses, local.full_params()


def _assert_params(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].detach().numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


# ------------------------------------------------------------ parameters

@pytest.mark.parametrize("cfg,n_stages", [
    (small_cfg(4), 4), (CFG4, 1), (CFG4, 2), (CFG4, 4),
    (dict(vocab_size=50257, d_model=768, n_heads=12, n_layers=8, d_ff=3072, max_len=1024), 4),
])
def test_stage_param_ranges_equal_jax(cfg, n_stages):
    got = mpmd.stage_param_ranges(PipelineLMConfig(**cfg), n_stages)
    assert got == jmpmd.stage_param_ranges(jpp.PipelineLMConfig(**cfg), n_stages)
    assert got[0][0] == 0
    for (lo, hi), (lo2, _) in zip(got, got[1:]):
        assert hi == lo2 and hi > lo


def test_stage_param_ranges_refuse_an_uneven_split():
    for fn in (lambda: mpmd.stage_param_ranges(PipelineLMConfig(**CFG4), 3),
               lambda: jmpmd.stage_param_ranges(jpp.PipelineLMConfig(**CFG4), 3)):
        with pytest.raises(ValueError, match="divide evenly"):
            fn()


@pytest.mark.parametrize("stage", range(4))
def test_stage_trees_carry_across_and_tile_the_ranges(stage):
    """One stage's JAX tree through ``pp_params_from_jax`` is the port's
    ``stage_param_tree`` of the same weights, leaf for leaf; it goes back
    through ``pp_params_to_jax`` unchanged; its parameter count is its
    range's width; and the stages assemble into the whole model."""
    jcfg, cfg = jpp.PipelineLMConfig(**CFG4), PipelineLMConfig(**CFG4)
    jfull = _np_tree(jpp.init_pp_params(jcfg, jax.random.key(0)))
    full = interop.pp_params_from_jax(jfull)
    jtree = _np_tree(jmpmd.stage_param_tree(jcfg, jfull, stage, 4))
    mine = mpmd.stage_param_tree(cfg, full, stage, 4)
    _assert_params(interop.pp_params_from_jax(jtree), mine, 0, 0)
    back = interop.pp_params_to_jax(mine)
    assert jax.tree.structure(back) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    lo, hi = mpmd.stage_param_ranges(cfg, 4)[stage]
    assert sum(t.numel() for t in mine.values()) == hi - lo
    assert mpmd.StageLM(cfg, 1, stage == 0, stage == 3).state_dict().keys() == mine.keys()
    trees = [mpmd.stage_param_tree(cfg, full, s, 4) for s in range(4)]
    _assert_params(mpmd.assemble_full_params(cfg, trees), full, 0, 0)


# ------------------------------------------------------------- exactness

def test_mpmd_local_matches_jax_and_the_single_stage_reference(jax_ref):
    """The port's 4-stage ``MpmdLocal`` from the JAX weights: its losses and
    updated weights are the JAX ``MpmdLocal``'s, and those of the port's
    one-stage reference on the same batch."""
    losses, final = _port_local(4, 4, jax_ref["init"])
    np.testing.assert_allclose(losses, jax_ref["gpipe"], rtol=1e-5)
    _assert_params(final, jax_ref["gpipe_final"], 3e-5, 1e-6)
    ref_losses, ref_final = _port_local(1, 1, jax_ref["init"])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _assert_params(final, ref_final, 3e-5, 1e-6)


def test_mpmd_schedules_identical(jax_ref):
    """GPipe against 1F1B: the same values per microbatch, summed in
    microbatch order, in both packages."""
    g, gf = _port_local(4, 4, jax_ref["init"])
    f, ff = _port_local(4, 4, jax_ref["init"], schedule="1f1b")
    np.testing.assert_allclose(f, g, rtol=1e-6)
    _assert_params(ff, gf, 1e-6, 1e-8)
    np.testing.assert_allclose(jax_ref["1f1b"], jax_ref["gpipe"], rtol=1e-6)
    np.testing.assert_allclose(f, jax_ref["1f1b"], rtol=1e-5)
    with pytest.raises(ValueError, match="schedule"):
        mpmd.MpmdLocal(PipelineLMConfig(**CFG4), 4, 4, LR, schedule="interleaved",
                       device="cpu")


def test_stage_programs_edges_and_cache():
    """A one-stage ``loss_bwd`` and stage 0's ``bwd`` return a zero ``d_x``
    (integer tokens); a middle stage has no loss; the process-wide cache
    hands a stage's key its one ``StagePrograms``."""
    cfg = PipelineLMConfig(**small_cfg(2))
    tokens, targets = make_batch(batch=2, seq=8)
    tok = torch.as_tensor(tokens % 32).long()
    tgt = torch.as_tensor(targets % 32).long()
    one = mpmd.stage_programs(cfg, 0, 1, 1, LR)
    assert one is mpmd.stage_programs(cfg, 0, 1, 1, LR)
    assert one is not mpmd.stage_programs(cfg, 0, 1, 2, LR)
    params = mpmd.init_stage_params(cfg, 0, 0, 1)
    ce, d_params, d_x = one.loss_bwd(params, tok, tgt)
    assert d_x.shape == () and float(d_x) == 0.0 and torch.isfinite(ce)
    assert d_params.keys() == params.keys()
    first = mpmd.stage_programs(cfg, 0, 2, 1, LR)
    p0 = mpmd.init_stage_params(cfg, 0, 0, 2)
    h = first.fwd(p0, tok)
    d_params, d_x = first.bwd(p0, tok, torch.ones_like(h))
    assert d_x.shape == () and d_params.keys() == p0.keys()
    with pytest.raises(ValueError, match="no loss"):
        first.loss_bwd(p0, tok, tgt)


def test_replay_covers_is_at_or_past_the_watermark():
    for step, mbi, m, wm in [(3, 0, 4, 12), (2, 3, 4, 12), (3, 1, 4, 12), (0, 0, 4, 0)]:
        assert mpmd.replay_covers(step, mbi, m, wm) == jmpmd.replay_covers(step, mbi, m, wm)
    assert mpmd.replay_covers(3, 0, 4, 12) and not mpmd.replay_covers(2, 3, 4, 12)


# ------------------------------------------------------------- durability

def test_stage_checkpoint_roundtrip_and_refusals(tmp_path):
    d = str(tmp_path / "ck")
    p = np.arange(10, dtype=np.float32)
    o = np.arange(4, dtype=np.float32)
    mpmd.save_stage_checkpoint(d, stage=2, step=7, watermark=28, lo=5, hi=15,
                               params_flat=p, opt_flat=o)
    meta, p2, o2 = mpmd.load_stage_checkpoint(d)
    assert (meta["stage"], meta["step"], meta["watermark"]) == (2, 7, 28)
    np.testing.assert_array_equal(p, p2)
    np.testing.assert_array_equal(o, o2)
    # the JAX package reads the port's file, and the port the JAX one's
    jmeta, jp, jo = jmpmd.load_stage_checkpoint(d)
    assert jmeta == meta and np.array_equal(jp, p) and np.array_equal(jo, o)
    jd = str(tmp_path / "jck")
    jmpmd.save_stage_checkpoint(jd, stage=2, step=7, watermark=28, lo=5, hi=15,
                                params_flat=p, opt_flat=o)
    with open(os.path.join(d, "stage.ckpt"), "rb") as a, \
            open(os.path.join(jd, "stage.ckpt"), "rb") as b:
        assert a.read() == b.read()
    # CRC damage (a flipped byte of the state) is refused loudly
    path = os.path.join(d, "stage.ckpt")
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        mpmd.load_stage_checkpoint(d)
    with pytest.raises(ValueError, match="unreadable"):
        mpmd.load_stage_checkpoint(str(tmp_path / "nope"))
    # a torn file (meta intact, state short) is refused
    raw = open(os.path.join(jd, "stage.ckpt"), "rb").read()
    head, _, blob = raw.partition(b"\n")
    import json
    import zlib
    meta = json.loads(head)
    meta["crc"] = zlib.crc32(blob[:-4]) & 0xFFFFFFFF
    with open(os.path.join(jd, "stage.ckpt"), "wb") as f:
        f.write(json.dumps(meta).encode() + b"\n" + blob[:-4])
    with pytest.raises(ValueError, match="size mismatch"):
        mpmd.load_stage_checkpoint(jd)


class _StubCoord:
    """Just enough of a ``CoordClient`` for one ``MpmdStage`` with no
    coordinator and no threads."""

    def __init__(self):
        self.on_stage_assign = None
        self.on_snapshot = None
        self._on_speculate = None
        self.incarnation = 1
        self.reports = []

    def report(self, *a, **k):
        self.reports.append(a)

    def stage_ready(self, *a, **k):
        pass

    def join(self, *a, **k):
        pass

    def snapshot_done(self, *a, **k):
        pass

    def stop(self):
        pass

    def close(self):
        pass


def _unit_stage(tmp_path, stage=1, n_stages=4, M=2, mb=2, seq=8):
    cfg = PipelineLMConfig(**small_cfg(n_stages, seq))
    world = InProcessTransport.create_world(1 + n_stages)
    srv = mpmd.MpmdStage(stage, cfg, n_stages, M, world[1 + stage], _StubCoord(), mb_size=mb,
                         seq_len=seq, lr=LR, ckpt_dir=str(tmp_path / f"stage{stage}"),
                         device="cpu")
    ranges = mpmd.stage_param_ranges(cfg, n_stages)
    placement = tst.StagePlacement(1, ranges[-1][1], [
        tst.StageEntry(stage=s, rank=1 + s, inc=100 + s, lo=lo, hi=hi)
        for s, (lo, hi) in enumerate(ranges)])
    srv._note_placement(placement)
    srv._drain_mailboxes()
    return cfg, world, srv


def _ship_frame(step, mbi, kind, body):
    return np.concatenate([
        np.asarray([*_split16(step), float(mbi), float(kind), 0.0, 0.0, 0.0], np.float32),
        np.asarray(body, np.float32).ravel()])


def _grad_frame(step, mbi, body):
    return np.concatenate([np.asarray([*_split16(step), float(mbi), 0.0, 0.0, 0.0],
                                      np.float32),
                           np.asarray(body, np.float32).ravel()])


def test_duplicate_grad_applied_once(tmp_path):
    """A duplicated ActivationGrad (a chaos dup, a redelivery, a replay)
    goes into the stage's update once; a duplicated input is dropped too,
    and traffic of a step already applied is stale."""
    cfg, world, srv = _unit_stage(tmp_path)
    act = np.zeros((2, 8, cfg.d_model), np.float32)
    srv.handle(1, MessageCode.ActivationShip, _ship_frame(0, 0, 0, act))
    srv._pump()
    assert srv.stats["fwd"] == 1
    # the forward went on to stage 2 (rank 3) as SHIP_ACT, stamped v1
    sender, code, payload = world[3].recv(timeout=1.0)
    assert (sender, code, int(payload[3]), int(payload[4])) == (2, MessageCode.ActivationShip,
                                                               mpmd.SHIP_ACT, 1)
    g = np.ones((2, 8, cfg.d_model), np.float32)
    srv.handle(3, MessageCode.ActivationGrad, _grad_frame(0, 0, g))
    srv._pump()
    assert srv.stats["bwd"] == 1
    srv.handle(3, MessageCode.ActivationGrad, _grad_frame(0, 0, g))
    srv._pump()
    assert srv.stats["bwd"] == 1 and srv.stats["dup_grads_dropped"] == 1
    srv.handle(1, MessageCode.ActivationShip, _ship_frame(0, 0, 0, act))
    assert srv.stats["dup_inputs_dropped"] == 1
    srv.handle(1, MessageCode.ActivationShip, _ship_frame(0, 1, 0, act))
    srv.handle(3, MessageCode.ActivationGrad, _grad_frame(0, 1, g))
    srv._pump()
    assert srv.step == 1 and srv.stats["updates"] == 1
    assert sorted(srv.applied_log) == [(0, 0), (0, 1)]
    assert srv.coord.reports[-1][:2] == (2, 1)  # watermark, step
    srv.handle(1, MessageCode.ActivationShip, _ship_frame(0, 0, 0, act))
    assert srv.stats["stale_dropped"] == 1
    # a lossy codec id on a token frame is malformed, not imprecise
    srv.handle(1, MessageCode.ActivationShip,
               np.concatenate([_ship_frame(1, 0, mpmd.SHIP_TOKENS, np.zeros(16))[:6], [1.0],
                               np.zeros(16, np.float32)]).astype(np.float32))
    assert srv.stats["malformed_dropped"] == 1


def test_stage_restore_refuses_bad_state(tmp_path):
    """The manifest's restore contract for a stage: a range that differs and
    a checkpoint BEHIND the promised apply seq are refused; a checkpoint of
    another stage too; the good path restores the watermark and the
    weights."""
    cfg, world, srv = _unit_stage(tmp_path)
    act = np.zeros((2, 8, cfg.d_model), np.float32)
    g = np.ones((2, 8, cfg.d_model), np.float32)
    for mbi in range(2):
        srv.handle(1, MessageCode.ActivationShip, _ship_frame(0, mbi, 0, act))
        srv.handle(3, MessageCode.ActivationGrad, _grad_frame(0, mbi, g))
    srv._pump()
    assert srv.step == 1 and srv.watermark == 2
    ranges = mpmd.stage_param_ranges(cfg, 4)

    def manifest(apply_seq, lo, hi):
        shards = []
        for s, (slo, shi) in enumerate(ranges):
            rec_lo, rec_hi = (lo, hi) if s == 1 else (slo, shi)
            shards.append(ShardRecord(server_id=1 + s, lo=rec_lo, hi=rec_hi, map_version=4,
                                      apply_seq=apply_seq if s == 1 else 0, push_count=1))
        return FleetManifest(snapshot_id=1, map_version=4, n_params=ranges[-1][1],
                             shards=tuple(shards))

    fresh = mpmd.MpmdStage(1, cfg, 4, 2, world[2], _StubCoord(), mb_size=2, seq_len=8, lr=LR,
                           ckpt_dir=str(tmp_path / "stage1"), device="cpu")
    with pytest.raises(ValueError, match="BEHIND"):
        fresh.restore(manifest(apply_seq=99, lo=ranges[1][0], hi=ranges[1][1]))
    with pytest.raises(ManifestError, match="range"):
        fresh.restore(manifest(apply_seq=0, lo=0, hi=1))
    other = mpmd.MpmdStage(2, cfg, 4, 2, world[3], _StubCoord(), mb_size=2, seq_len=8, lr=LR,
                           ckpt_dir=str(tmp_path / "stage1"), device="cpu")
    with pytest.raises(ValueError, match="for stage 1"):
        other.restore()
    fresh.restore(manifest(apply_seq=2, lo=ranges[1][0], hi=ranges[1][1]))
    assert fresh.step == 1 and fresh.watermark == 2
    _assert_params(fresh.params, srv.params, 0, 0)


def test_recorder_and_obs_dir_are_refused(tmp_path):
    """The flight recorder, refused until the observability plane was
    ported, is taken: a stage with ``recorder=`` and ``obs_dir=`` attributes
    its serve loop's wall clock to exclusive states (here, before any
    placement, all ``idle``) and dumps its ring at its stop, which both
    packages' timeline analyzers read alike; the driver keeps both. A bad
    ``act_codec`` is still refused."""
    from distributed_ml_pytorch_tpu.analysis import timeline as jtimeline
    from distributed_ml_pytorch_tpu_torch.analysis import timeline
    from distributed_ml_pytorch_tpu_torch.utils.obs import SpanRecorder

    cfg = PipelineLMConfig(**small_cfg(2))
    world = InProcessTransport.create_world(3)
    obs_dir = str(tmp_path / "obs")
    rec = SpanRecorder("stage0", "mpmd")
    srv = mpmd.MpmdStage(0, cfg, 2, 1, world[1], _StubCoord(), mb_size=1, seq_len=8,
                         device="cpu", recorder=rec, obs_dir=obs_dir)
    srv.run(timeout=0.2)
    assert sorted(os.listdir(obs_dir)) == ["flight_stage0_stop.jsonl"]
    report = timeline.analyze(obs_dir)
    assert report == {**jtimeline.analyze(obs_dir), "dump_dir": obs_dir}
    (member,) = report["members"]
    assert member["member"] == "stage0" and set(member["seconds"]) == {"idle"}
    assert abs(member["accounted"] - 1.0) < 1e-3
    drv = mpmd.MpmdDriver(world[0], _StubCoord(), 2, 1, recorder=rec, obs_dir=obs_dir)
    assert (drv.recorder, drv.obs_dir) == (rec, obs_dir)
    with pytest.raises(ValueError, match="act_codec"):
        mpmd.MpmdStage(0, cfg, 2, 1, world[1], _StubCoord(), mb_size=1, seq_len=8,
                       act_codec="topk", device="cpu")


# ------------------------------------------------------------- placement

def test_stage_placement_codec_roundtrip_across_packages():
    entries = [dict(stage=0, rank=1, inc=0x12345, lo=0, hi=400, watermark=8),
               dict(stage=1, rank=-1, inc=0, lo=400, hi=999, watermark=12)]
    p = tst.StagePlacement(7, 999, [tst.StageEntry(**e) for e in entries])
    jp = jst.StagePlacement(7, 999, [jst.StageEntry(**e) for e in entries])
    assert p.encode().tobytes() == jp.encode().tobytes()
    q = tst.StagePlacement.decode(jp.encode())
    assert q.version == 7 and q.n_params == 999 and q.entries == p.entries
    assert q.entries[1].vacant and not q.assigned
    jq = jst.StagePlacement.decode(p.encode())
    assert [dataclass_tuple(e) for e in jq.entries] == [dataclass_tuple(e) for e in p.entries]
    assert tst.encode_stage_ready(2, 0xABCDE, 40).tobytes() == \
        jst.encode_stage_ready(2, 0xABCDE, 40).tobytes()
    with pytest.raises(ValueError, match="malformed"):
        tst.StagePlacement.decode(np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="entries"):
        tst.StagePlacement.decode(np.asarray([*_split16(1), 5.0, *_split16(10)], np.float32))


def dataclass_tuple(e):
    return (e.stage, e.rank, e.inc, e.lo, e.hi, e.watermark)


@pytest.mark.parametrize("inc_only", [False, True])
def test_placement_deltas_equal_jax(inc_only):
    def both(rows):
        return (tst.StagePlacement(1, 10, [tst.StageEntry(*r) for r in rows]),
                jst.StagePlacement(1, 10, [jst.StageEntry(*r) for r in rows]))

    old = [(0, 1, 5, 0, 4, 0), (1, 2, 6, 4, 8, 0), (2, 3, 7, 8, 10, 0)]
    for new in ([(0, 1, 5, 0, 4, 0), (1, -1, 6, 4, 8, 0), (2, 3, 7, 8, 10, 0)],
                [(0, 1, 5, 0, 4, 0), (1, 2, 6, 4, 8, 0), (2, 3, 9, 8, 10, 12)],
                [(0, 4, 5, 0, 4, 0), (1, 2, 6, 4, 8, 0), (2, 3, 7, 8, 10, 0)]):
        (to, jo), (tn, jn) = both(old), both(new)
        got = [dataclass_tuple(e) for e in tst.placement_deltas(to, tn, inc_only=inc_only)]
        want = [dataclass_tuple(e) for e in jst.placement_deltas(jo, jn, inc_only=inc_only)]
        assert got == want
    assert tst.placement_deltas(None, both(old)[0]) == []


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _Sent:
    """A coordinator's transport that keeps what it is asked to send."""

    def __init__(self):
        self.frames = []
        self.rank = 0

    def send(self, code, payload, dst=0):
        self.frames.append((int(dst), int(code), np.asarray(payload).tobytes()))

    def close(self):
        pass


@pytest.mark.parametrize("straggler", [False, True])
def test_stage_coordinator_decides_as_jax(straggler):
    """The two packages' ``StageCoordinator`` fed one frame script on one
    clock: joins, ``StageReady``s, a stage's death by lease expiry, its
    replacement (the restart MTTR), a same-life re-admission, and (with a
    standby) a straggler raced: the same decisions, placements and frames."""
    ranges = mpmd.stage_param_ranges(PipelineLMConfig(**small_cfg(4)), 4)
    runs = []
    for co, enc_join, enc_renew, enc_ready in (
            (tst.StageCoordinator, tco.encode_join, tco.encode_renew, tst.encode_stage_ready),
            (jst.StageCoordinator, None, None, jst.encode_stage_ready)):
        if enc_join is None:
            from distributed_ml_pytorch_tpu.coord import coordinator as jco
            enc_join, enc_renew = jco.encode_join, jco.encode_renew
        clock, sent = _Clock(), _Sent()
        c = co(sent, ranges, lease=0.5, clock=clock,
               straggler_factor=5.0 if straggler else 0.0)
        ranks = [1, 2, 3, 4] + ([5] if straggler else [])
        for r in ranks:
            c.handle(r, MessageCode.CoordJoin, enc_join(tco.KIND_STAGE, 10 + r))
        for s in range(4):
            c.handle(1 + s, MessageCode.StageReady, enc_ready(s, 10 + 1 + s, 0))
        c.handle(2, MessageCode.StageReady, enc_ready(1, 11 + 1, 0))  # idempotent
        for step in range(1, 5):
            clock.t += 0.2
            for r in ranks:
                ms = 50.0 if r == 2 else 5.0
                c.handle(r, MessageCode.LeaseRenew, enc_renew(10 + r, 4 * step, step, ms))
            c.tick()
        # rank 3 (stage 2) goes silent and dies; a new life takes its stage
        for _ in range(4):
            clock.t += 0.2
            for r in ranks:
                if r != 3:
                    c.handle(r, MessageCode.LeaseRenew, enc_renew(10 + r, 16, 4, 5.0))
            c.tick()
        c.handle(3, MessageCode.CoordJoin, enc_join(tco.KIND_STAGE, 99))
        clock.t += 0.05
        c.handle(3, MessageCode.StageReady, enc_ready(2, 99, 16))
        c.handle(3, MessageCode.StageReady, enc_ready(2, 98, 16))  # stale life
        c.handle(3, MessageCode.StageReady, enc_ready(7, 99, 16))  # no such stage
        c.tick()
        runs.append((list(c.events), c.placement.encode().tobytes(), list(c.stage_mttrs),
                     c.stage_restarts, sent.frames, dict(c.stage_speculated)))

    (te, tp, tm, tr, tf, ts), (je, jp, jm, jr, jf, js) = runs
    assert te == je
    assert tp == jp and tm == jm and tr == jr == 1 and ts == js
    assert tf == jf
    assert any("restored by rank 3" in e for e in te)
    assert any("stage straggler" in e for e in te) == straggler


def test_chip_smoke_phase_28_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.phase_mpmd`` at tiny widths on the CPU, with
    ``ops.attention``'s CUDA wrappers routed to their plain versions and
    counting a launch where the kernel would launch (under a lock: the
    stages are threads): every part's gate holds, the fault-free fleet's
    counts are the schedule's with the flight recorders on, its bubble's
    attribution sums to 1, and ``coord.cli --mpmd`` exits 0."""
    import json
    import sys
    import threading

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from distributed_ml_pytorch_tpu_torch.ops import attention as at

    lock = threading.Lock()
    plain_fwd, plain_bwd = at.flash_fwd_plain, at.flash_bwd_fused_plain

    def counted(name, fn):
        def launch(*args):
            with lock:
                at.launches[name] += 1
            return fn(*args)
        return launch

    monkeypatch.setattr(at, "flash_fwd_cuda", counted("flash_fwd", plain_fwd))
    monkeypatch.setattr(at, "flash_bwd_fused_cuda", counted("flash_bwd_fused", plain_bwd))
    monkeypatch.setattr(at, "flash_fwd_plain", lambda *a: at.flash_fwd_cuda(*a))
    monkeypatch.setattr(at, "flash_bwd_fused_plain", lambda *a: at.flash_bwd_fused_cuda(*a))
    launches, errors = cs.phase_mpmd(torch, device="cpu", tiny=True)
    lines = {d["phase"]: d for d in (json.loads(ln) for ln in capsys.readouterr().out
                                     .splitlines() if ln.startswith('{"phase"'))}
    assert set(lines) == {"mpmd_oracle", "mpmd_fleet", "mpmd_stage_death", "mpmd_int8",
                          "mpmd_cli", "mpmd"}
    assert all(d["ok"] for d in lines.values())
    cfg = cs._mpmd_shapes(True)[0]
    assert launches == lines["mpmd_fleet"]["expected_launches"] == cs._mpmd_expected(
        cfg, cs.TINY_MPMD["steps"])
    assert launches["flash_fwd"] == (3 * 2 + 1) * 1 * 4 * 4
    assert errors == {}
    # the flight recorders' attribution of the fleet's bubble (they add no
    # launch: the counts above are the schedule's)
    attr = lines["mpmd_fleet"]["bubble_attribution"]
    assert attr["stages"] == 4 and abs(lines["mpmd_fleet"]["attribution_sum"] - 1) <= 0.02
    assert set(lines["mpmd_fleet"]["members"]) == {f"stage{i}" for i in range(4)}
    assert lines["mpmd_stage_death"]["stage_mttr_ms"] > 0
    assert "'ok': True" in lines["mpmd_cli"]["summary"]
    build = os.path.join(cs.ROOT, "build")
    assert not any(n.startswith("mpmd28_") for n in
                   (os.listdir(build) if os.path.isdir(build) else ()))


def test_attention_launch_counts_lose_no_update_across_threads():
    """The stage members of one process launch attention kernels from their
    own threads at once: the launch counts take a lock, so none is lost
    (16 threads, more than the cores, the interpreter switching every
    microsecond)."""
    import sys
    import threading

    from distributed_ml_pytorch_tpu_torch.ops import attention as at

    before = dict(at.launches)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [at._count("flash_fwd")
                                                     for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert at.launches["flash_fwd"] - before["flash_fwd"] == 16 * 2000
    at.launches.update(before)
