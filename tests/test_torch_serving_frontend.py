"""The port's serving frontend and ``serve`` CLI, on the CPU
(``tests/test_serving_frontend.py`` is the list mirrored): client →
frontend → engine over the in-process and TCP transports, reject frames,
cancel and resume, the submit codecs against the JAX package's, and the
CLI's demo and unported flags."""

import queue
import threading

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.serving import frontend as jfe
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.models.generate import generate
from distributed_ml_pytorch_tpu_torch.serving import frontend as tfe
from distributed_ml_pytorch_tpu_torch.serving.engine import ServingEngine
from distributed_ml_pytorch_tpu_torch.serving.frontend import (
    RequestRejected,
    ServingClient,
    ServingFrontend,
)
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    InProcessTransport,
    MessageCode,
    TCPTransport,
)

VOCAB = 64


@pytest.fixture(scope="module")
def model():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield TransformerLM(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                        max_len=128, seed=3, device="cpu")
    torch.set_num_threads(prev)


def make_engine(model, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("cache_size", 64)
    kw.setdefault("decode_block", 4)
    kw.setdefault("prefill_bucket", 8)
    return ServingEngine(model, **kw)


class served:
    """An in-process 2-rank world: rank 0 the engine's hub, rank 1 a client."""

    def __init__(self, engine, **kw):
        self.world = InProcessTransport.create_world(2)
        self.frontend = ServingFrontend(engine, self.world[0], **kw)
        self.thread = threading.Thread(target=self.frontend.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return ServingClient(self.world[1])

    def __exit__(self, *exc):
        self.frontend.stop()
        self.thread.join(timeout=10)
        for t in self.world.values():
            t.close()
        assert not self.thread.is_alive()


def test_inprocess_streams_equal_engine_and_generate(model):
    prompt = np.random.default_rng(0).integers(0, VOCAB, size=5)
    want = generate(model, prompt[None], 14)[0, 5:].tolist()
    sampled = generate(model, prompt[None], 14, temperature=0.8, top_k=8, seed=5)[0, 5:]
    with served(make_engine(model)) as client:
        assert client.generate(prompt, 14) == want
        assert client.generate(prompt, 14, temperature=0.8, top_k=8, seed=5) == \
            sampled.tolist()


def test_inprocess_concurrent_streams_and_cancel(model):
    with served(make_engine(model)) as client:
        ra = client.submit(np.arange(4), 20)
        rb = client.submit(np.arange(6), 8)
        rc = client.submit(np.arange(2), 30)
        client.cancel(rc)
        assert len(list(client.stream(ra))) == 20
        assert len(list(client.stream(rb))) == 8
        assert len(list(client.stream(rc, timeout=30.0))) < 30


def test_backpressure_rejects_over_transport(model):
    with served(make_engine(model, slots=1, max_queue=1)) as client:
        rids = [client.submit(np.arange(4), 12) for _ in range(4)]
        outcomes = []
        for rid in rids:
            try:
                outcomes.append(len(list(client.stream(rid, timeout=60.0))))
            except RequestRejected:
                outcomes.append("rejected")
        assert "rejected" in outcomes and 12 in outcomes


def test_resume_replays_from_an_offset(model):
    with served(make_engine(model)) as client:
        rid = client.submit(np.arange(5), 10)
        full = list(client.stream(rid))
        # a reconnecting client (same rank) asks for the tail from 4 on
        client.resume_from(rid, 4)
        assert list(client.stream(rid, n_have=4)) == full[4:]
        # a resume for an id the engine never saw is rejected
        client.resume_from(999, 0)
        with pytest.raises(RequestRejected):
            list(client.stream(999, timeout=10.0))


def test_overload_shed_and_brownout(model):
    world = served(make_engine(model, slots=1), shed_occupancy=2.0, brownout_occupancy=1.0,
                   brownout_max_new=3)
    with world as client:
        assert len(client.generate(np.arange(4), 20)) == 20  # alone: no brownout
        # back to back: the pump takes the frames in microseconds, the engine
        # a decode block in milliseconds, so the later ones meet pressure
        rids = [client.submit(np.arange(4), 20, priority=p) for p in (0, 0, 1)]
        outcomes = []
        for rid in rids:
            try:
                outcomes.append(len(list(client.stream(rid, timeout=60.0))))
            except RequestRejected:
                outcomes.append("rejected")
    fe = world.frontend
    assert fe.brownouts >= 1 and 3 in outcomes
    assert outcomes.count("rejected") == fe.shed
    assert all(n in (3, 20, "rejected") for n in outcomes)


def test_malformed_frames_do_not_kill_the_hub(model):
    engine = make_engine(model)
    with served(engine) as client:
        rid = next(client._ids)
        client._buffers[rid] = queue.Queue()
        client.transport.send(MessageCode.SubmitRequest,
                              np.asarray([rid, 5, 0, 0, 1, 0, -1], np.float32), dst=0)
        with pytest.raises(RequestRejected):
            list(client.stream(rid, timeout=10.0))
        client.transport.send(MessageCode.CancelRequest, np.zeros(0, np.float32), dst=0)
        assert len(client.generate(np.arange(4), 6)) == 6


def test_tcp_roundtrip(model):
    engine = make_engine(model)
    port = 29627
    server_tp = {}
    boot = threading.Thread(target=lambda: server_tp.setdefault("t", TCPTransport(0, 2,
                                                                                port=port)))
    boot.start()
    client_tp = TCPTransport(1, 2, port=port)
    boot.join(timeout=30)
    frontend = ServingFrontend(engine, server_tp["t"])
    thread = threading.Thread(target=frontend.serve_forever, daemon=True)
    thread.start()
    try:
        toks = ServingClient(client_tp).generate(np.arange(6), 10)
        assert len(toks) == 10 and all(0 <= t < VOCAB for t in toks)
    finally:
        frontend.stop()
        thread.join(timeout=5)
        client_tp.close()
        server_tp["t"].close()


@pytest.mark.parametrize("v2", [False, True])
def test_submit_codecs_equal_jax(v2):
    kw = dict(temperature=0.7, top_k=5, top_p=0.9, seed=12, eos_token=3)
    if v2:
        kw.update(priority=2, deadline_ms=150, session=9)
        enc, dec = "encode_submit_v2", "decode_submit_v2"
    else:
        enc, dec = "encode_submit", "decode_submit"
    frame = getattr(tfe, enc)(7, [1, 2, 3], 16, **kw)
    np.testing.assert_array_equal(frame, getattr(jfe, enc)(7, [1, 2, 3], 16, **kw))
    got, want = getattr(tfe, dec)(frame), getattr(jfe, dec)(frame)
    assert got[0] == want[0] and got[1] == want[1] and got[3:] == want[3:]
    np.testing.assert_array_equal(got[2], want[2])
    with pytest.raises(ValueError, match="2\\^24"):
        getattr(tfe, enc)(1, [1, 2], 8, seed=1 << 24)
    with pytest.raises(ValueError, match="malformed"):
        getattr(tfe, dec)(np.zeros(5, np.float32))


def test_frontend_rejects_the_coordinator_hold(model):
    world = InProcessTransport.create_world(2)
    try:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            ServingFrontend(make_engine(model), world[0], fleet=object())
    finally:
        for t in world.values():
            t.close()


def test_serve_cli_demo_on_cpu(capsys):
    from distributed_ml_pytorch_tpu_torch.serving.cli import main

    rc = main(["--demo", "4", "--backend", "cpu", "--vocab", "64", "--d-model", "32",
               "--n-heads", "4", "--n-layers", "1", "--d-ff", "64", "--slots", "2",
               "--cache-size", "64", "--decode-block", "4", "--prefill-bucket", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "serving demo complete" in out and "ttft_ms" in out


@pytest.mark.parametrize("argv", [["--fleet", "2"], ["--coord", "localhost:1"], ["--reliable"],
                                  ["--ckpt-dir", "ckpt"], ["--metrics-dump", "-"],
                                  ["--d-model", "30"]])
def test_serve_cli_rejects_unported_or_bad_flags(argv, capsys):
    from distributed_ml_pytorch_tpu_torch.serving.cli import parse_args

    with pytest.raises(SystemExit):
        parse_args(["--backend", "cpu", *argv])
    err = capsys.readouterr().err
    assert "not ported yet" in err or "divide" in err
