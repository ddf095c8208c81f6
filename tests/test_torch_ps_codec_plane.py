"""The port's parameter server and worker on the optimizer and codec plane,
against the JAX package's. Bit for bit unless a test states a tolerance:

- a port server and a JAX server fed one sequence from two senders (dense
  and compressed pushes, full and delta pulls between them) under Adasum or
  add with sgdm or adam, a WAL and a checkpoint every 4 pushes: the replies,
  the central vector, the WAL records (payload, codec id, sender, seq) and
  ``ps_opt.npz`` equal;
- each server's directory restored by the other package, with the WAL tail
  replayed through the optimizer: the vector and the optimizer state equal
  the live server's;
- delta replies from a port server installed by a JAX ``Listener``, and the
  other way round, each view equal to the server's tracked base;
- the epoch fence: after a restore, a view from before it gets a full
  install, never a delta;
- a compressed push whose decoded norm is huge quarantined (nacked, not
  logged), and one with a corrupt CRC dropped and counted;
- the sharded server's per-range optimizer;
- the slice as a whole: a LeNet worker per package from the same weights on
  the same batches, with ``--compress int8 --combine adasum --server-opt
  sgdm``, one in-process world each pumped after every step; the central
  vectors after 8 steps within the tolerance the int8 step sets
  (:func:`test_the_slice_as_a_whole_stays_within_the_int8_step_of_jax`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from distributed_ml_pytorch_tpu.parallel import async_ps as jps
from distributed_ml_pytorch_tpu.parallel import optplane as jopt
from distributed_ml_pytorch_tpu.parallel import sharded_ps as jsps
from distributed_ml_pytorch_tpu.training.trainer import cross_entropy_loss as jce
from distributed_ml_pytorch_tpu.utils import compress as jc
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu.utils.health import GradientAdmission as JAdmission
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.parallel import optplane as topt
from distributed_ml_pytorch_tpu_torch.parallel import sharded_ps as tsps
from distributed_ml_pytorch_tpu_torch.training import cli
from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
from distributed_ml_pytorch_tpu_torch.utils import compress as tc
from distributed_ml_pytorch_tpu_torch.utils import interop
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.health import GradientAdmission
from distributed_ml_pytorch_tpu_torch.utils.wal import replay_wal

N = 3000
TCode, JCode = tmsg.MessageCode, jmsg.MessageCode


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.uint32),
                                  np.asarray(b, np.float32).view(np.uint32))


def _servers(tmp_path, combine="add", kind=None, wal=True, ckpt_every=4, n=N, **kw):
    """A port and a JAX server over the same vector, each with its world."""
    init = np.random.default_rng(11).normal(size=n).astype(np.float32)
    out = []
    for tag, msg, ps, opt in (("port", tmsg, tps, topt), ("jax", jmsg, jps, jopt)):
        world = msg.InProcessTransport.create_world(3)
        optimizer = (opt.ShardedOptimizer(kind, 0, n, lr=0.5, momentum=0.5)
                     if kind else None)
        out.append((ps.ParameterServer(params=init, transport=world[0],
                                       ckpt_dir=str(tmp_path / tag) if wal else None,
                                       ckpt_every=ckpt_every, wal=wal, combine=combine,
                                       optimizer=optimizer, **kw), world))
    return out


def _take(world, rank):
    msg = world[rank].recv(timeout=2)
    assert msg is not None, "no reply"
    return int(msg[1]), np.asarray(msg[2], np.float32)


def _records(path):
    recs, _ = replay_wal(os.path.join(path, "ps_wal.log"))
    return [(r.seq, r.sender, r.codec, r.payload) for r in recs]


def _logged(server):
    """Every record ``server`` appends to its WAL, as ``(seq, sender, codec,
    payload)`` (a checkpoint truncates the file itself)."""
    seen, real = [], server.wal.append

    def append(seq, payload, **kw):
        seen.append((seq, kw["sender"], kw["codec"], np.array(payload, np.float32)))
        return real(seq, payload, **kw)

    server.wal.append = append
    return seen


def _npz(path):
    with np.load(path) as d:
        return {k: d[k].copy() for k in d.files}


def _sequence(seed=0, n=N, steps=36):
    """``[(sender, kind, payload)]``: sender 1 pushes dense and pulls in
    full, sender 2 pushes int8 or top-k frames and pulls with its held
    stamp (made when the pull is sent)."""
    rng = np.random.default_rng(seed)
    enc = {c: tc.CompressingEncoder(n, tc.make_codec(c, k_frac=0.02)) for c in ("int8", "topk")}
    events = []
    for i in range(steps):
        sender = 1 + int(rng.integers(0, 2))
        r = rng.random()
        if r < 0.3:
            events.append((sender, "pull", None))
            continue
        raw = rng.normal(scale=0.01, size=n).astype(np.float32)
        if sender == 1:
            events.append((1, "dense", raw))
        else:
            head, body = enc["int8" if i % 3 else "topk"].encode_range(raw, 0, n)
            events.append((2, "compressed", np.concatenate([head, body])))
    if sum(kind != "pull" for _, kind, _ in events) % 4 == 0:
        # a push past the last checkpoint: the restore must replay a tail
        events.append((1, "dense", rng.normal(scale=0.01, size=n).astype(np.float32)))
    return events


def _run(server, world, listener, events, code_mod):
    replies = []
    for sender, kind, payload in events:
        if kind == "dense":
            server.handle(sender, code_mod.MessageCode.GradientUpdate, payload)
        elif kind == "compressed":
            server.handle(sender, code_mod.MessageCode.CompressedUpdate, payload)
        elif sender == 1:
            server.handle(1, code_mod.MessageCode.ParameterRequest, np.zeros(0, np.float32))
            replies.append(_take(world, 1))
        else:
            server.handle(2, code_mod.MessageCode.ParameterRequest, listener.held_stamp())
            code, frame = _take(world, 2)
            listener.receive(0, code_mod.MessageCode(code), frame)
            replies.append((code, frame))
    return replies


@pytest.mark.parametrize("combine,kind", [("adasum", "sgdm"), ("add", "adam"),
                                          ("adasum", "adam")])
def test_one_sequence_gives_equal_servers_logs_and_optimizer_files(tmp_path, combine, kind):
    (mine, tw), (ref, jw) = _servers(tmp_path, combine, kind)
    events = _sequence()
    tl, jl = tps.Listener(transport=tw[2]), jps.Listener(transport=jw[2])
    tlog, jlog = _logged(mine), _logged(ref)
    treplies = _run(mine, tw, tl, events, tmsg)
    jreplies = _run(ref, jw, jl, events, jmsg)
    assert [c for c, _ in treplies] == [c for c, _ in jreplies]
    assert int(TCode.DeltaParams) in [c for c, _ in treplies]
    for (_, a), (_, b) in zip(treplies, jreplies):
        _same(a, b)
    mine.commit()
    ref.commit()
    _same(mine.central, ref.central)
    assert (mine._apply_seq, mine.delta_replies, mine.full_replies,
            mine.delta_reply_wire_floats) == (ref._apply_seq, ref.delta_replies,
                                              ref.full_replies, ref.delta_reply_wire_floats)
    assert mine.delta_replies >= 2 and mine._apply_seq % 4, "want a WAL tail past the checkpoint"
    _same(tl._view, jl._view)
    assert (tl.full_installs, tl.delta_installs) == (jl.full_installs, jl.delta_installs)
    assert [r[:3] for r in tlog] == [r[:3] for r in jlog]
    assert {r[2] for r in tlog} == {0, 1, 2}  # dense, int8 and top-k pushes logged
    trecs, jrecs = _records(str(tmp_path / "port")), _records(str(tmp_path / "jax"))
    assert [r[:3] for r in trecs] == [r[:3] for r in jrecs] == [r[:3] for r in tlog[-len(trecs):]]
    assert trecs
    for a, b in zip(tlog + trecs, jlog + jrecs):
        _same(a[3], b[3])
    topt_file, jopt_file = _npz(mine._opt_path()), _npz(ref._opt_path())
    assert sorted(topt_file) == sorted(jopt_file)
    for k in topt_file:
        np.testing.assert_array_equal(topt_file[k], jopt_file[k])
    _same(mine.optimizer.m, ref.optimizer.m)
    _same(mine.optimizer.v, ref.optimizer.v)
    assert mine.optimizer.t == ref.optimizer.t

    # each directory restores in the other package, the tail replayed
    # through the optimizer
    live = {"central": mine.central.copy(), "m": mine.optimizer.m.copy(),
            "v": mine.optimizer.v.copy(), "t": mine.optimizer.t, "seq": mine._apply_seq}
    mine.wal.close()
    ref.wal.close()
    for pkg, opt, d in ((tps, topt, "jax"), (jps, jopt, "port")):
        fresh = pkg.ParameterServer(params=np.zeros(N, np.float32), ckpt_dir=str(tmp_path / d),
                                    wal=True, combine=combine,
                                    optimizer=opt.ShardedOptimizer(kind, 0, N, lr=0.5,
                                                                   momentum=0.5))
        assert fresh.maybe_restore()
        assert fresh.replayed_updates > 0 and fresh._apply_seq == live["seq"]
        _same(fresh.central, live["central"])
        _same(fresh.optimizer.m, live["m"])
        _same(fresh.optimizer.v, live["v"])
        assert fresh.optimizer.t == live["t"]
        fresh.wal.close()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_delta_replies_install_across_the_packages(tmp_path, server_pkg):
    (mine, tw), (ref, jw) = _servers(tmp_path, wal=False)
    if server_pkg == "port":
        server, world, msg, other, other_code = mine, tw, tmsg, jps.Listener(transport=jw[2]), JCode
    else:
        server, world, msg, other, other_code = ref, jw, jmsg, tps.Listener(transport=tw[2]), TCode
    rng = np.random.default_rng(5)
    codes = []
    for _ in range(6):
        server.handle(2, msg.MessageCode.ParameterRequest, other.held_stamp())
        code, frame = _take(world, 2)
        codes.append(code)
        other.receive(0, other_code(code), frame)
        _same(other._view, server._pull_bases[2][2])
        server.handle(1, msg.MessageCode.GradientUpdate,
                      rng.normal(scale=1e-3, size=N).astype(np.float32))
    assert codes == [int(TCode.DeltaParams)] * 6
    assert (other.full_installs, other.delta_installs, other.delta_base_miss) == (1, 5, 0)
    assert server.delta_replies == 5 and server.full_replies == 1
    # the view tracks central less what top-k could not carry yet
    assert np.abs(other._view - server.central).max() < 1e-2


def test_a_delta_never_lands_on_a_view_from_before_a_restore(tmp_path):
    (mine, tw), (ref, jw) = _servers(tmp_path, kind="sgdm")
    tl, jl = tps.Listener(transport=tw[2]), jps.Listener(transport=jw[2])
    rng = np.random.default_rng(6)
    for server, world, listener, msg in ((mine, tw, tl, tmsg), (ref, jw, jl, jmsg)):
        for _ in range(3):
            server.handle(1, msg.MessageCode.GradientUpdate,
                          rng.normal(size=N).astype(np.float32))
            server.handle(2, msg.MessageCode.ParameterRequest, listener.held_stamp())
            listener.receive(0, msg.MessageCode.DeltaParams, _take(world, 2)[1])
        server.commit()
        server.save_checkpoint()
        server.wal.close()
    assert tl.delta_installs == jl.delta_installs == 2
    held = tl.held_stamp()
    _same(held, jl.held_stamp())
    for pkg, d, world, msg in ((tps, "port", tw, tmsg), (jps, "jax", jw, jmsg)):
        fresh = pkg.ParameterServer(params=np.zeros(N, np.float32), transport=world[0],
                                    ckpt_dir=str(tmp_path / d), wal=True)
        assert fresh.maybe_restore() and fresh._pull_epoch == 1
        fresh.handle(2, msg.MessageCode.ParameterRequest, held)
        code, frame = _take(world, 2)
        assert code == int(TCode.DeltaParams) and int(frame[0]) == tc.CODEC_DENSE
        assert int(frame[1]) == 1  # the new epoch
        fresh.wal.close()


def test_a_delta_against_an_unknown_base_is_counted_and_dropped(tmp_path):
    (mine, tw), _ = _servers(tmp_path, wal=False)
    tl = tps.Listener(transport=tw[2])
    mine.handle(2, TCode.ParameterRequest, tl.held_stamp())
    tl.receive(0, TCode.DeltaParams, _take(tw, 2)[1])
    mine.handle(1, TCode.GradientUpdate, np.full(N, 0.1, np.float32))
    mine.handle(2, TCode.ParameterRequest, tl.held_stamp())
    _code, delta = _take(tw, 2)
    stale = tps.Listener(transport=tw[2])  # holds no view
    stale.receive(0, TCode.DeltaParams, delta)
    assert (stale.delta_base_miss, stale.delta_installs, stale.full_installs) == (1, 0, 0)
    assert stale.take_latest() is None
    tl.receive(0, TCode.DeltaParams, delta)
    assert tl.delta_installs == 1
    _same(tl.take_latest(), mine._pull_bases[2][2])


def _int8_frame(x):
    enc = tc.CompressingEncoder(x.size, tc.make_codec("int8"))
    return np.concatenate(enc.encode_range(x, 0, x.size))


def test_a_huge_decoded_norm_is_quarantined_and_a_corrupt_crc_dropped(tmp_path):
    (mine, tw), (ref, jw) = _servers(tmp_path, ckpt_every=0)
    mine.admission = GradientAdmission(z_max=6.0, warmup=4)
    ref.admission = JAdmission(z_max=6.0, warmup=4)
    for server, msg in ((mine, tmsg), (ref, jmsg)):
        rng = np.random.default_rng(8)
        for _ in range(6):
            server.handle(1, msg.MessageCode.CompressedUpdate,
                          _int8_frame(rng.normal(scale=0.01, size=N).astype(np.float32)))
        huge = _int8_frame(rng.normal(scale=1e4, size=N).astype(np.float32))
        server.handle(1, msg.MessageCode.CompressedUpdate, huge)
        bad = _int8_frame(rng.normal(scale=0.01, size=N).astype(np.float32))
        bad[-1] += 1.0
        server.handle(1, msg.MessageCode.CompressedUpdate, bad)
        server.handle(1, msg.MessageCode.CompressedUpdate, bad[:12])
        server.commit()
    for server, world in ((mine, tw), (ref, jw)):
        assert (server.quarantined, server.nacks_sent, server.dropped_bad_updates,
                server._apply_seq) == (1, 1, 2, 6)
        code, _ = _take(world, 1)
        assert code == int(TCode.UpdateNack)
    _same(mine.central, ref.central)
    assert len(_records(str(tmp_path / "port"))) == 6


@pytest.mark.parametrize("kind", ["sgdm", "adam"])
def test_the_sharded_server_steps_an_optimizer_over_exactly_its_range(kind):
    n, k = 1001, 2
    flat = np.random.default_rng(9).normal(size=n).astype(np.float32)
    rng = np.random.default_rng(10)
    pushes = [rng.normal(scale=0.01, size=n).astype(np.float32) for _ in range(5)]
    for s, (lo, hi) in enumerate(tsps.shard_ranges(n, k)):
        mine = tsps.make_shard_server(params=flat, shard=s, n_shards=k, server_opt=kind,
                                      server_opt_kw={"lr": 0.5, "momentum": 0.5},
                                      combine="adasum")
        ref = jsps.make_shard_server(params=flat, shard=s, n_shards=k, server_opt=kind,
                                     server_opt_kw={"lr": 0.5, "momentum": 0.5},
                                     combine="adasum")
        assert (mine.optimizer.lo, mine.optimizer.hi) == (ref.optimizer.lo,
                                                          ref.optimizer.hi) == (lo, hi)
        assert mine.optimizer.state_floats() == 2 * (hi - lo)
        enc = tc.CompressingEncoder(n, tc.make_codec("topk"))
        for p in pushes:
            frame = np.concatenate(enc.encode_range(p, lo, hi))
            mine.handle(1, TCode.CompressedUpdate, frame)
            ref.handle(1, JCode.CompressedUpdate, frame)
        _same(mine.central, ref.central)
        _same(mine.optimizer.m, ref.optimizer.m)
        assert mine.combine == "adasum"


def test_the_cli_refuses_adasum_with_damping_and_passes_the_flags(monkeypatch):
    with pytest.raises(SystemExit):
        cli.main(["--rank", "1", "--combine", "adasum", "--staleness-damping", "0.5"])
    seen = []
    monkeypatch.setattr(tps, "run_ps_process", lambda args: seen.append(args) or 0)
    monkeypatch.setattr(tsps, "run_sharded_ps_process", lambda args: seen.append(args) or 0)
    flags = ["--compress", "topk", "--compress-topk", "0.05", "--compress-block", "256",
             "--combine", "adasum", "--server-opt", "adam", "--server-lr", "0.1",
             "--server-momentum", "0.8"]
    for k in ("1", "2"):
        assert cli.main(["--rank", "0", "--world-size", "4", "--n-servers", k, *flags]) == 0
    for args in seen:
        assert tc.compress_from_args(args) == {
            "compress": "topk", "compress_opts": {"block": 256, "k_frac": 0.05}}
        assert topt.server_opt_from_args(args) == ("adam", {"lr": 0.1, "momentum": 0.8})
        assert args.combine == "adasum"
    args = cli.build_parser().parse_args(["--model", "lenet", "--world-size", "3", *flags])
    server = tps.make_server(args)
    assert server.combine == "adasum" and server.optimizer.kind == "adam"
    assert server.optimizer.size == server.central.size


#: the slice as a whole: the two packages' LeNet gradients differ by float
#: summation order (~1e-7 relative), which can move an int8 rounding by one
#: step (a block's scale, absmax / 127). A push's input is its accumulator
#: plus the residual, which is within half a step of the other package's, so
#: two decoded pushes differ by at most two steps an element; sgdm (momentum
#: 0.9, lr 1) applies the k-th push from the end (1 - 0.9^k) / 0.1 times.
#: Allowed: 2 steps of the largest scale pushed times the sum of those
#: weights over the pushes, plus 1e-6 of float32 noise.
SLICE_STEPS = 8


def _slice_worlds(argv):
    """The JAX world's and the port's servers after :data:`SLICE_STEPS`
    steps of ``argv``, and the largest int8 scale of each port push."""
    from distributed_ml_pytorch_tpu.models import get_model as jget_model

    jmodel = jget_model("lenet")
    jparams = jmodel.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))["params"]
    flat0 = np.asarray(ravel_pytree(jparams)[0], np.float32)
    state = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    get_model("lenet", device="cpu"))
    rng = np.random.default_rng(12)
    batches = [(rng.uniform(-1, 1, size=(8, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, size=8)) for _ in range(SLICE_STEPS)]
    args = cli.build_parser().parse_args(argv)

    @jax.jit
    def jgrad(p, bx, by):
        return jax.grad(lambda q: jce(jmodel.apply({"params": q}, bx), by))(p)

    def run(pkg):
        msg = jmsg if pkg == "jax" else tmsg
        world = msg.InProcessTransport.create_world(2)
        opt_mod = jopt if pkg == "jax" else topt
        server = (jps if pkg == "jax" else tps).ParameterServer(
            params=np.zeros_like(flat0), transport=world[0], combine=args.combine,
            optimizer=opt_mod.optimizer_from_args(args, flat0.size))
        kw = (jc if pkg == "jax" else tc).compress_from_args(args)
        if pkg == "jax":
            opt = jps.Asynchronous(jparams, lr=args.lr, n_push=args.num_push,
                                   n_pull=args.num_pull, transport=world[1], **kw)
            held = jparams
        else:
            model = get_model("lenet", device="cpu")
            model.load_state_dict(state)
            model.dropout_rate = 0.0  # the JAX side applies the model without dropout
            opt = tps.Asynchronous(model, lr=args.lr, n_push=args.num_push,
                                   n_pull=args.num_pull, transport=world[1], **kw)
        opt.listener.stop()
        opt.listener.join(timeout=5)
        if pkg == "port" and opt.encoder is not None:
            enc, real = opt.encoder, opt.encoder.encode_range

            def recording(arr, lo, hi, stamp=None):
                p = np.asarray(arr, np.float32)[lo:hi] + enc.residual[lo:hi]
                scales.append(float(np.abs(p).max()) / 127.0)
                return real(arr, lo, hi, stamp)

            enc.encode_range = recording

        def pump(rank, handle):
            while (m := world[rank].recv(timeout=0.01)) is not None:
                handle(m[0], msg.MessageCode(int(m[1])), m[2])

        pump(0, server.handle)  # the install
        for bx, by in batches:
            if pkg == "jax":
                held = opt.step(held, jgrad(held, bx, by.astype(np.int32)))
            else:
                loss_and_grads(model, torch.from_numpy(bx), torch.from_numpy(by))
                opt.step()
            opt._flusher.drain()
            pump(0, server.handle)
            pump(1, opt.listener.receive)
        opt._flusher.stop()
        return server

    scales = []
    return run("jax"), run("port"), scales, flat0


def test_the_slice_as_a_whole_stays_within_the_int8_step_of_jax():
    ref, mine, scales, flat0 = _slice_worlds(
        ["--model", "lenet", "--compress", "int8", "--combine", "adasum", "--server-opt",
         "sgdm", "--num-push", "2", "--num-pull", "3", "--lr", "0.05"])
    for server, code in ((ref, JCode), (mine, TCode)):
        assert server.message_counts[code.CompressedUpdate] == SLICE_STEPS // 2
        assert server.message_counts[code.GradientUpdate] == 0
    assert ref.optimizer.kind == mine.optimizer.kind == "sgdm"
    assert len(scales) == SLICE_STEPS // 2
    weights = sum((1 - 0.9 ** k) / 0.1 for k in range(1, len(scales) + 1))
    tol = 2 * max(scales) * weights + 1e-6
    diff = float(np.abs(mine.central - ref.central).max())
    assert diff <= tol, (diff, tol)
    assert np.abs(mine.central - flat0).max() > 10 * diff  # the run moved the vector
