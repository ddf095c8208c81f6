"""The port's ``bench_all`` legs on the CPU at tiny widths, and the timing and
FLOP plumbing under them (``utils/devtime.py``, ``utils/flops.py``) against
the JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.utils import flops as jflops
from distributed_ml_pytorch_tpu_torch import bench_all
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.utils import flops as tflops
from distributed_ml_pytorch_tpu_torch.utils.devtime import DeviceTiming, device_time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(bench_all.TINY_LM, pos_encoding="rope")
LM_METRICS = ["transformer_lm_seq8192_train_throughput", "gpt2_small_seq2048_train_throughput",
              "gpt2_small_seq8192_train_throughput"]
LADDER_METRICS = [f"conv_epilogue_{name}_{tag}_fwdbwd"
                  for name in ("conv1_tail", "conv2_tail", "conv5_tail", "bias_relu")
                  for tag in ("unfused", "fused")]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def spies(monkeypatch):
    """Count which train-step builder ``bench_lm`` takes."""
    calls = {"fused_head": 0, "ad": 0}

    def spy(key, real):
        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(bench_all, "make_fused_head_sgd_step",
                        spy("fused_head", bench_all.make_fused_head_sgd_step))
    monkeypatch.setattr(bench_all, "make_fsdp_lm_train_step",
                        spy("ad", bench_all.make_fsdp_lm_train_step))
    return calls


@pytest.mark.parametrize("head", [True, False])
def test_bench_lm_takes_the_fused_head_step_for_a_head_model(spies, head):
    # head=False returns hidden states, so the AD step's CE runs over d_model
    # classes: keep the vocabulary within them
    lm = TransformerLM(**dict(TINY, vocab_size=64), head=head, device="cpu")
    before = [p.detach().clone() for p in lm.parameters()]
    rate = bench_all.bench_lm(lm, batch=2, seq=32, n_long=2, tag="tiny")
    assert spies == ({"fused_head": 1, "ad": 0} if head else {"fused_head": 0, "ad": 1})
    assert rate.step_kind == ("fused-head" if head else "AD")
    assert rate > 0 and rate.source == "wallclock" and rate.step_seconds > 0
    assert rate.mfu is None  # no peak for the CPU
    # 2 warm-up + 2 timed steps trained the model
    assert any(not torch.equal(a, p) for a, p in zip(before, lm.parameters()))
    dense = sum(m.weight.numel() for m in lm.modules() if isinstance(m, torch.nn.Linear))
    assert rate.flops_per_step >= 6 * dense * 2 * 32


def test_bench_all_main_on_cpu_emits_the_jax_metric_names(capsys, spies):
    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "lm,conv_epilogue"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == LM_METRICS + LADDER_METRICS
    assert spies == {"fused_head": 3, "ad": 0}
    for r in recs:
        assert set(r) >= {"config", "metric", "value", "unit", "hardware", "note"}
        assert r["hardware"] == "1x cpu" and r["value"] > 0
        assert r["config"] == (6 if r["metric"] in LM_METRICS else 1)
        assert "wallclock" in r["note"]
    assert all("--tiny" in r["note"] for r in recs[:3])
    # the names are the JAX harness's own
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        src = fh.read()
    for m in LM_METRICS:
        assert f'"{m}"' in src, m
    assert 'f"conv_epilogue_{name}_{tag}_fwdbwd"' in src
    assert 'f"conv_epilogue_bias_relu_{tag}_fwdbwd"' in src


def test_bench_all_main_rejects_unknown_legs(capsys):
    with pytest.raises(SystemExit):
        bench_all.main(["--device", "cpu", "--legs", "moe"])
    assert "unknown" in capsys.readouterr().err


def test_compute_microbench_phase_on_cpu():
    out = bench_all.compute_microbench_phase("cpu", batch=4)
    assert list(out) == LADDER_METRICS
    assert all(v["fwd_us"] > 0 and v["fwdbwd_us"] > 0 for v in out.values())


# ------------------------------------------------------------------ devtime, flops

def test_device_time_on_cpu_is_wallclock():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    t = device_time(fn, torch.ones(3), calls=4, warmup=2)
    assert isinstance(t, DeviceTiming) and t.source == "wallclock"
    assert t.calls == 4 and len(calls) == 6 and t.per_call_s > 0
    assert t.per_call_ms == t.per_call_s * 1e3
    with pytest.raises(ValueError, match="warmup"):
        device_time(fn, torch.ones(1), warmup=0)
    with pytest.raises(ValueError, match="no tensor"):
        device_time(lambda: None, calls=1, warmup=1)
    # the first tensor of a nested result places the timing
    assert device_time(lambda: {"a": [None, torch.zeros(1)]}, calls=1, warmup=1).source == \
        "wallclock"


@pytest.mark.parametrize("hybrid,analytic", [(1.0e12, 1.1e12), (1.0e12, 2.0e12), (None, 1e12),
                                             (5.0, 0.0)])
def test_check_flops_agreement_matches_jax(hybrid, analytic):
    assert tflops.check_flops_agreement(hybrid, analytic) == \
        jflops.check_flops_agreement(hybrid, analytic)


def test_utilization():
    name = "NVIDIA H100 80GB HBM3"
    tf, mfu = tflops.utilization(989.4e12 * 0.25, 1.0, name)
    assert tf == pytest.approx(247.35) and mfu == pytest.approx(0.25)
    assert tflops.utilization(1e12, 2.0, "cpu") == (0.5, None)
    assert tflops.utilization(None, 1.0, name) == (None, None)
    assert tflops.utilization(1e12, 0.0, name) == (None, None)
    # the JAX function's arithmetic, where both know the device
    jtf, _ = jflops.utilization(3e12, 1.5)
    assert tflops.utilization(3e12, 1.5, "cpu")[0] == pytest.approx(jtf)


def test_rate_record_fields():
    r = bench_all.Rate.make(1000.0, 2e12, 0.5, "NVIDIA H100 80GB HBM3")
    rec = r.record_fields()
    assert rec["flops_per_step"] == 2e12 and rec["tflops"] == 4.0
    assert rec["mfu"] == round(4e12 / 989.4e12, 4)
    assert "MFU" in r.mfu_note() and float(r) == 1000.0
    assert bench_all.Rate.make(1.0, None, 0.5).record_fields() == {}
    assert np.isclose(bench_all.Rate.make(1.0, 1e12, 1.0, "cpu").tflops, 1.0)
