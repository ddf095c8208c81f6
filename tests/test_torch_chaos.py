"""The port's ``utils/chaos.py`` against the JAX package's.

- For plans covering drop, dup, delay, reorder and corrupt with
  ``after``/``until`` windows, and weather, SDC and gray rules, the same
  seeded frame sequences go through both packages' ``FaultyTransport`` over
  their in-process worlds: the delivered frames, the ``ChaosLog.lines()``
  bytes and ``counts()`` are equal. The decisions are numpy draws from one
  ``SeedSequence`` per channel in both, so the bits agree.
- A plan's JSON written by either package loads in the other as an equal
  plan; unknown fields raise in both.
- The imperative hooks (partition, crash and restart, ``gray_stall``) act
  alike.
- The JAX chaos acceptance world (``tests/test_chaos.py::
  test_async_ps_chaos_deterministic_and_converges``) on the port's LeNet:
  three runs byte-identical, in the fault-free run's corridor, and equal to
  the JAX run's log for the same plan and cadence.
"""

import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.utils import chaos as jchaos
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu_torch.utils import chaos as tchaos
from distributed_ml_pytorch_tpu_torch.utils import compress as tcompress
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

GU, PR, PU = 2, 1, 0  # GradientUpdate, ParameterRequest, ParameterUpdate
CU = 34  # CompressedUpdate


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _plan(mod, spec):
    """``spec`` = (rules, weather, sdc, gray) as kwargs dicts -> a plan of
    ``mod``'s classes."""
    rules, weather, sdc, gray, seed = spec
    return mod.ChaosPlan([mod.FaultRule(**r) for r in rules], seed=seed,
                         weather=[mod.WeatherRule(**w) for w in weather],
                         sdc=[mod.SDCRule(**s) for s in sdc],
                         gray=[mod.GrayRule(**g) for g in gray])


#: (name, (rules, weather, sdc, gray, seed), ordered): ``ordered`` plans
#: deliver each channel's frames in a fixed order; a delayed or weathered
#: frame lands whenever its timer fires, so those compare as multisets
PLANS = [
    ("drop_dup", ([dict(drop=0.2, dup=0.15)], [], [], [], 7), True),
    ("windowed", ([dict(code=GU, drop=0.5, after=4, until=12), dict(dup=0.3, src=1)],
                  [], [], [], 11), True),
    ("reorder_corrupt", ([dict(reorder=0.25, corrupt=0.2)], [], [], [], 3), True),
    ("delay", ([dict(delay=0.02, delay_p=0.3, drop=0.1)], [], [], [], 5), False),
    ("weather", ([dict(drop=0.1)], [dict(src=1, latency=0.01, jitter=0.005)], [], [], 9),
     False),
    ("sdc", ([dict(dup=0.1)], [], [dict(code=GU, p=0.4, kind="bitflip"),
                                   dict(code=PU, p=0.5, kind="scale", factor=-2.0, skip=1),
                                   dict(code=PR, p=0.5, kind="nan")], [], 13), True),
    ("gray", ([dict(drop=0.05)], [], [], [dict(kind="partition", src=2, dst=0, after=6,
                                               until=10),
                                          dict(kind="lossy", src=1, p=0.3)], 17), True),
]


def _frames(seed=0, n=20):
    """The scripted traffic: ``n`` frames from each of ranks 1 and 2 to rank
    0 on three codes, and replies back, seeded payloads (some empty)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        for src in (1, 2):
            code = (GU, PR, PU)[i % 3]
            size = 0 if code == PR and i % 2 else int(rng.integers(1, 9))
            out.append((src, 0, code, rng.standard_normal(size).astype(np.float32)))
        out.append((0, 1 + i % 2, PU, rng.standard_normal(5).astype(np.float32)))
    return out


def _drive(mod, msg_mod, spec, frames, wait):
    world = msg_mod.InProcessTransport.create_world(3)
    wrapped, log = mod.FaultyTransport.wrap_world(world, _plan(mod, spec))
    for src, dst, code, payload in frames:
        wrapped[src].send(msg_mod.MessageCode(code), payload, dst=dst)
    if wait:
        time.sleep(0.2)  # every delayed frame's timer has fired
    for t in wrapped.values():
        t.close()  # flushes any reorder-held frame
    got = {}
    for rank, t in world.items():
        box = []
        while True:
            try:
                s, c, p = t._boxes[rank].get_nowait()
            except Exception:  # noqa: BLE001 — the queue is empty
                break
            box.append((int(s), int(c), p.tobytes()))
        got[rank] = box
    return got, log


@pytest.mark.parametrize("name,spec,ordered", PLANS, ids=[p[0] for p in PLANS])
def test_plans_deliver_and_log_as_jax(name, spec, ordered):
    frames = _frames(seed=len(name))
    mine, mlog = _drive(tchaos, tmsg, spec, frames, not ordered)
    ref, rlog = _drive(jchaos, jmsg, spec, frames, not ordered)
    assert mlog.lines() == rlog.lines() and mlog.lines()
    assert mlog.counts() == rlog.counts()
    for rank in ref:
        if ordered:
            assert mine[rank] == ref[rank], rank
        else:
            assert sorted(mine[rank]) == sorted(ref[rank]), rank


def test_sdc_restamps_a_compressed_push_as_jax():
    """SDC on a CompressedUpdate body re-stamps its CRC in both packages:
    the corrupted frame arrives decodable, with the same bytes."""
    enc = tcompress.CompressingEncoder(64, tcompress.make_codec("int8", block=16))
    arr = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    frames = [(1, 0, CU, np.concatenate(enc.encode_range(arr * (i + 1), 0, 64)))
              for i in range(8)]
    spec = ([], [], [dict(code=CU, p=0.6, kind="scale", factor=4.0,
                          skip=tcompress.HEAD_LEN)], [], 21)
    mine, mlog = _drive(tchaos, tmsg, spec, frames, False)
    ref, rlog = _drive(jchaos, jmsg, spec, frames, False)
    assert mine == ref and mlog.lines() == rlog.lines()
    assert mlog.counts().get("sdc-scale", 0) > 0
    for _s, _c, raw in mine[0]:
        tcompress.decode_update(np.frombuffer(raw, np.float32))  # the CRC holds


def test_sdc_on_a_reliable_envelope_is_logged_once_per_frame_as_jax():
    """An enveloped frame's SDC decision is a function of its seq: the
    port's reliable wire over the chaos layer logs what the JAX one does."""
    def run(mod, msg_mod):
        plan = mod.ChaosPlan(sdc=[mod.SDCRule(code=GU, p=0.5, kind="bitflip")], seed=2)
        world, log = msg_mod.make_world(2, reliable=True, plan=plan,
                                        reliable_opts={"ack_timeout": 0.05})
        for i in range(10):
            world[1].send(msg_mod.MessageCode.GradientUpdate,
                          np.full(6, float(i), np.float32))
        got = []
        while len(got) < 10:
            m = world[0].recv(timeout=5)
            assert m is not None
            got.append(m[2].tobytes())
        for t in world.values():
            t.close()
        return got, log.lines()

    mine, mlines = run(tchaos, tmsg)
    ref, rlines = run(jchaos, jmsg)
    assert sorted(mine) == sorted(ref) and mlines == rlines and "sdc-bitflip" in mlines


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_plan_json_loads_in_the_other_package(writer):
    spec = ([dict(code=GU, drop=0.5, after=4, until=12), dict(dup=0.3, src=1)],
            [dict(latency=0.01, bandwidth=1e6)], [dict(p=0.1, kind="nan")],
            [dict(kind="stall", src=1, p=0.5, stall_ms=3.0, site="fsync")], 11)
    mine, ref = _plan(tchaos, spec), _plan(jchaos, spec)
    src, dst = (tchaos, jchaos) if writer == "port" else (jchaos, tchaos)
    data = src.plan_to_json(mine if writer == "port" else ref)
    loaded = dst.plan_from_json(data)
    assert dst.plan_to_json(loaded) == data
    want = ref if writer == "port" else mine
    assert ([dataclasses.asdict(r) for r in loaded.rules + loaded.weather + loaded.sdc
             + loaded.gray], loaded.seed) == (
        [dataclasses.asdict(r) for r in want.rules + want.weather + want.sdc + want.gray],
        want.seed)
    for mod in (tchaos, jchaos):
        with pytest.raises(ValueError, match="unknown"):
            mod.plan_from_json({"seed": 1, "ruels": []})
        with pytest.raises(ValueError, match="unknown"):
            mod.plan_from_json({"rules": [{"drpo": 0.1}]})


def test_imperative_hooks_act_as_jax():
    """partition/heal, crash/restart and crash_rank, and gray stalls."""
    outcomes = {}
    for name, mod, msg_mod in (("port", tchaos, tmsg), ("jax", jchaos, jmsg)):
        plan = mod.ChaosPlan(gray=[mod.GrayRule(kind="stall", src=1, p=0.5, stall_ms=2.0,
                                                site="serve")], seed=4)
        world, log = mod.FaultyTransport.wrap_world(
            msg_mod.InProcessTransport.create_world(3), plan)
        res = []
        world[1].partition(0)
        world[1].send(msg_mod.MessageCode.GradientUpdate, np.ones(2, np.float32))
        world[1].heal(0)
        world[1].send(msg_mod.MessageCode.GradientUpdate, np.ones(2, np.float32))
        world[2].crash()
        for s, d in ((2, 0), (1, 2)):
            try:
                world[s].send(msg_mod.MessageCode.Heartbeat, np.zeros(0, np.float32), dst=d)
                res.append("sent")
            except ConnectionError:
                res.append("refused")
        res.append(world[2].recv(timeout=0.01))
        world[2].restart()
        world[0].crash_rank(1)
        try:
            world[1].send(msg_mod.MessageCode.Heartbeat, np.zeros(0, np.float32))
            res.append("sent")
        except ConnectionError:
            res.append("refused")
        world[0].restart_rank(1)
        res.append([world[1].gray_stall("serve") for _ in range(12)])
        res.append(mod.gray_injector(world[1]) is world[1])
        res.append(world[0].recv(timeout=0.1)[1:2])
        outcomes[name] = (res, log.lines(), log.counts())
        for t in world.values():
            t.close()
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][2]["partition-drop"] == 1


# ---------------------------------------------------------------- DownPour world

def _port_world(plan):
    return cs.chaos_ps_world(torch, plan, model="lenet", device="cpu")


def test_downpour_chaos_world_is_deterministic_and_in_the_corridor():
    """Three runs of the acceptance plan: byte-identical logs, both fault
    kinds fired, every worker's loss falling and the fleet in the
    fault-free run's corridor (0.45, the JAX test's)."""
    clean, _, _ = _port_world(None)
    clean_final = np.mean([np.mean(v[-6:]) for v in clean.values()])
    logs = []
    for _run in range(3):
        results, log, server = _port_world(cs.acceptance_plan())
        assert np.isfinite(server.central).all()
        logs.append(log.lines())
        for losses in results.values():
            assert np.mean(losses[-6:]) < np.mean(losses[:6]), losses
        final = np.mean([np.mean(v[-6:]) for v in results.values()])
        assert abs(final - clean_final) < cs.CHAOS_CORRIDOR, (final, clean_final)
    assert logs[0] and logs[0] == logs[1] == logs[2]
    assert "drop" in logs[0] and "dup" in logs[0]


def test_downpour_chaos_log_equals_the_jax_worlds():
    """The JAX acceptance world (its LeNet, its ParameterServer and
    Asynchronous workers) under the same plan and cadence logs the port
    world's faults byte for byte: the channel sequences are the same."""
    import jax
    import jax.numpy as jnp

    from distributed_ml_pytorch_tpu.data import load_cifar10
    from distributed_ml_pytorch_tpu.models import LeNet
    from distributed_ml_pytorch_tpu.parallel.async_ps import Asynchronous, ParameterServer
    from distributed_ml_pytorch_tpu.training.trainer import cross_entropy_loss
    from distributed_ml_pytorch_tpu.utils.serialization import ravel_model_params

    model = LeNet()
    x, y, *_ = load_cifar10(n_train=256, n_test=32, synthetic=True)

    @jax.jit
    def grad_fn(p, bx, by, rng):
        def loss_fn(q):
            logits = model.apply({"params": q}, bx, train=True, rngs={"dropout": rng})
            return cross_entropy_loss(logits, by)

        return jax.value_and_grad(loss_fn)(p)

    params0 = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    plan = jchaos.ChaosPlan([jchaos.FaultRule(code=int(c), drop=0.10, dup=0.05)
                             for c in (GU, PR, PU)], seed=cs.CHAOS_SEED)
    world, log = jchaos.FaultyTransport.wrap_world(jmsg.InProcessTransport.create_world(3),
                                                   plan)
    server = ParameterServer(params=np.asarray(ravel_model_params(params0)),
                             transport=world[0], n_workers=2)
    st = threading.Thread(target=server.run, kwargs={"timeout": 180})
    st.start()

    def worker(rank):
        params = jax.tree.map(jnp.asarray, params0)
        opt = Asynchronous(params, lr=cs.CHAOS_LR, n_push=cs.CHAOS_CADENCE,
                           n_pull=cs.CHAOS_CADENCE, transport=world[rank])
        for step in range(cs.CHAOS_STEPS):
            sel = np.random.default_rng(rank * 100 + step).integers(0, len(x), cs.CHAOS_BATCH)
            _loss, grads = grad_fn(params, x[sel], y[sel],
                                   jax.random.fold_in(jax.random.key(rank), step))
            params = opt.step(params, grads)
        opt.finish()

    threads = [threading.Thread(target=worker, args=(r,)) for r in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    st.join(timeout=60)
    for t in world.values():
        t.close()
    _results, mine, _server = _port_world(cs.acceptance_plan())
    assert mine.lines() == log.lines() and log.lines()
