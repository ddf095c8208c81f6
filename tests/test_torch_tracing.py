"""The port's ``TraceWindow`` on ``torch.profiler`` (CPU activities here),
through the JAX ``tests/test_tracing.py`` cases: a bounded window writes a
trace, a run that ends inside the window is closed by ``close``,
``after_step`` bounds it exactly, a window with no directory is a no-op, a
window never reached warns, and a chunk that strides over the window opens
it. Beside them: ``annotate_step`` ranges in the trace, the trainer's
``--profile-dir`` window over the CLI, and the window's step bounds held to
the JAX class's decisions on the same calls."""

import json
import os

import pytest
import torch

from distributed_ml_pytorch_tpu_torch.utils.tracing import TraceWindow, annotate_step


def _work(step):
    with annotate_step("train", step):
        x = torch.ones(32, 32)
        return (x @ x).sum()


def _trace_names(tw):
    with open(tw.trace_path) as fh:
        return [e["name"] for e in json.load(fh)["traceEvents"]]


def test_trace_window_captures_bounded_steps(tmp_path):
    profile_dir = str(tmp_path / "trace")
    tw = TraceWindow(profile_dir, start=2, n_steps=2)
    for step in range(6):
        tw.on_step(step)
        _work(step)
    tw.close()
    assert os.listdir(profile_dir) == [os.path.basename(tw.trace_path)]
    names = _trace_names(tw)
    # on_step(4) closed the window before step 4 ran: steps 2 and 3 only
    assert sorted(n for n in names if n.startswith("train#")) == ["train#2", "train#3"]


def test_trace_window_closes_when_run_ends_inside_window(tmp_path):
    tw = TraceWindow(str(tmp_path / "trace2"), start=1, n_steps=10)
    for step in range(3):
        tw.on_step(step)
        _work(step)
        tw.after_step(step + 1)
    assert tw._active
    tw.close()
    assert not tw._active and tw._done and os.path.isfile(tw.trace_path)


def test_trace_window_after_step_bounds_exactly(tmp_path):
    tw = TraceWindow(str(tmp_path / "trace3"), start=0, n_steps=2)
    tw.on_step(0)
    _work(0)
    tw.after_step(1)
    assert tw._active
    tw.on_step(1)
    _work(1)
    tw.after_step(2)
    assert not tw._active and tw._done
    _work(2)  # after the window: not in the trace
    assert sorted(n for n in _trace_names(tw) if n.startswith("train#")) == [
        "train#0", "train#1"]


def test_trace_window_disabled_is_noop(tmp_path, capsys):
    tw = TraceWindow(None)
    for step in range(5):
        tw.on_step(step)
    tw.close()
    tw.warn_if_never_opened()
    assert tw.trace_path is None and capsys.readouterr().err == ""


def test_trace_window_warns_when_never_reached(tmp_path, capsys):
    tw = TraceWindow(str(tmp_path / "unused"), start=100, n_steps=10)
    for step in range(3):
        tw.on_step(step)
    tw.close()
    tw.warn_if_never_opened()
    err = capsys.readouterr().err
    assert "never reached" in err and "lower --profile-start" in err
    assert not os.path.exists(tmp_path / "unused")
    resumed = TraceWindow(str(tmp_path / "unused"), start=2, n_steps=2)
    resumed.on_step(50)
    resumed.warn_if_never_opened()
    assert "raise --profile-start past the resume point" in capsys.readouterr().err


def test_trace_window_opens_when_chunk_strides_over_it(tmp_path):
    tw = TraceWindow(str(tmp_path / "trace4"), start=10, n_steps=10)
    tw.on_step(0, n_steps=32)  # the chunk [0, 32) strides over [10, 20)
    assert tw._active
    _work(0)
    tw.after_step(32)
    assert tw._done


@pytest.mark.parametrize("calls", [
    [("on", 0, 1), ("on", 1, 1), ("after", 2), ("on", 2, 1), ("after", 3), ("on", 3, 1)],
    [("on", 0, 8), ("after", 8), ("on", 8, 8), ("after", 16)],
    [("on", 5, 1), ("on", 6, 1), ("on", 7, 1), ("close",)],
])
def test_window_decisions_equal_the_jax_class(calls, monkeypatch):
    """The open/close decisions of the two classes on the same calls (the
    JAX profiler calls are stubbed: only the step logic is compared)."""
    import jax

    from distributed_ml_pytorch_tpu.utils.tracing import TraceWindow as JTraceWindow

    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    mine, ref = TraceWindow("unused-dir", start=2, n_steps=3), JTraceWindow("unused-dir", 2, 3)
    monkeypatch.setattr(mine, "_open", lambda: setattr(mine, "_active", True))
    monkeypatch.setattr(mine, "close", lambda: (setattr(mine, "_done", mine._done or mine._active),
                                                setattr(mine, "_active", False)))
    for call in calls:
        for tw in (mine, ref):
            if call[0] == "on":
                tw.on_step(call[1], n_steps=call[2])
            elif call[0] == "after":
                tw.after_step(call[1])
            else:
                tw.close()
        assert (mine._active, mine._done) == (ref._active, ref._done), call


def test_trainer_profile_window_over_the_cli(tmp_path, capsys):
    from distributed_ml_pytorch_tpu_torch.training import cli

    prof = tmp_path / "prof"
    assert cli.main(["--no-distributed", "--backend", "cpu", "--model", "lenet",
                     "--synthetic-data", "--synthetic-train-size", "48",
                     "--synthetic-test-size", "16", "--batch-size", "8", "--epochs", "1",
                     "--log-dir", str(tmp_path), "--profile-dir", str(prof),
                     "--profile-start", "1", "--profile-steps", "2"]) == 0
    assert f"wrote profiler trace to {prof}" in capsys.readouterr().out
    (name,) = os.listdir(prof)
    with open(prof / name) as fh:
        names = [e["name"] for e in json.load(fh)["traceEvents"]]
    assert sorted(n for n in names if n.startswith("train#")) == ["train#1", "train#2"]


def test_chip_smoke_profile_window_rehearses_on_the_cpu(capsys):
    """``chip_smoke.phase_profile_window`` on the CPU (the K2 counts are
    the card's; here the step ranges): its trace holds ``train#0`` and
    ``train#1``."""
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    line = cs.phase_profile_window(torch, device="cpu", batch=16)
    assert line["step_ranges"] == ["train#0", "train#1"] and line["trace_bytes"] > 0
    assert '"phase": "trainer_profile_window"' in capsys.readouterr().out
