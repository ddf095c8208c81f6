"""The port's timeline analyzer over the JAX package's canned flight dumps
(``tests/test_timeline.py``'s cases, on ``tests/data/timeline/``: a stage
with an attribution summary, a death dump with spans only, a torn dump and
an unknown plane), its report equal to the JAX analyzer's, its CLI, and the
``mpmd`` leg's ``check_bubble_attribution`` gate held to the JAX one."""

import json
import os
import sys

import pytest

from distributed_ml_pytorch_tpu.analysis import timeline as jtimeline
from distributed_ml_pytorch_tpu_torch import bench_all
from distributed_ml_pytorch_tpu_torch.analysis import cli, timeline

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "data", "timeline")


@pytest.fixture(scope="module")
def report():
    return timeline.analyze(FIXTURES)


def _jax_bench():
    sys.path.insert(0, ROOT)
    try:
        import bench_all as jax_bench
    finally:
        sys.path.remove(ROOT)
    return jax_bench


def test_report_equals_the_jax_analyzers(report):
    assert report == jtimeline.analyze(FIXTURES)
    assert timeline.render(report) == jtimeline.render(report)
    assert [d["member"] for d in timeline.load_dir(FIXTURES)] == [
        d["member"] for d in jtimeline.load_dir(FIXTURES)]


def test_loads_all_dumps_and_counts_torn_lines(report):
    assert report["n_dumps"] == 4 and report["torn_lines"] == 2
    (d,) = [d for d in timeline.load_dir(FIXTURES) if d["member"] == "driver"]
    assert len(d["events"]) == 1 and len(d["spans"]) == 1
    assert report["ring_dropped_spans"] == 1


def test_unknown_plane_surfaced_not_dropped(report):
    assert report["unknown_planes"] == ["quantum"]
    (mystery,) = [m for m in report["members"] if m["member"] == "mystery"]
    assert mystery["accounted"] == pytest.approx(1.0, abs=1e-6)


def test_attribution_prefers_summary_and_sums_to_one(report):
    s0 = next(m for m in report["members"] if m["member"] == "stage0")
    assert s0["wall_s"] == 10.0
    assert s0["fractions"]["compute"] == pytest.approx(0.4)
    assert s0["fractions"]["wait-grad"] == pytest.approx(0.3)
    assert s0["accounted"] == pytest.approx(1.0, abs=1e-6) and s0["unknown_states"] == []


def test_attribution_fallback_sums_spans_for_death_dump(report):
    s1 = next(m for m in report["members"] if m["member"] == "stage1")
    assert s1["reason"] == "death" and s1["wall_s"] == pytest.approx(10.0)
    assert s1["seconds"]["compute"] == pytest.approx(4.5)
    assert s1["seconds"]["wire-blocked"] == pytest.approx(2.0)
    assert s1["accounted"] == pytest.approx(1.0, abs=1e-6)


def test_bubble_aggregates_stage_members(report):
    b = report["bubble_attribution"]
    assert b["stages"] == 2 and b["stage_seconds"] == pytest.approx(20.0)
    assert b["fractions"]["compute"] == pytest.approx(0.425)
    assert b["bubble_fraction"] == pytest.approx(0.575)
    assert b["wait_fraction"] + b["fractions"]["compute"] == pytest.approx(1.0, abs=1e-3)


def test_wire_attribution_from_wire_stats_events(report):
    w = report["wire_attribution"]
    assert w["members_reporting"] == 1 and (w["sent"], w["retries"]) == (100, 5)
    assert w["retransmit_share"] == pytest.approx(0.05) and w["ack_frames"] == 25
    assert w["acks_per_data_frame"] == pytest.approx(25 / 95)
    assert w["credit_block_s"] == pytest.approx(0.25)


def test_correlation_journeys_cross_members(report):
    j = report["journeys"]
    assert j["cross_member_units"] >= 2 and len(j["longest"][0]["members"]) >= 2


def test_render_is_human_readable(report):
    text = timeline.render(report)
    assert "bubble" in text and "stage0" in text
    assert "unknown plane" in text and "torn" in text


def test_cli_timeline_subcommand(capsys):
    assert cli.main(["timeline", FIXTURES]) == 0
    assert "bubble" in capsys.readouterr().out
    assert cli.main(["timeline", FIXTURES, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == timeline.analyze(FIXTURES)


def test_missing_dir_raises_and_empty_dir_exits_nonzero(tmp_path):
    with pytest.raises(FileNotFoundError):
        timeline.analyze(str(tmp_path / "nope"))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["timeline", str(empty)]) == 1


@pytest.mark.parametrize("argv", [["distmodel"], [], ["lint"]])
def test_cli_refuses_the_subcommands_not_ported(argv):
    with pytest.raises(SystemExit):
        cli.main(argv)


# ------------------------------------------------ the bubble's schema gate

def _good_attr():
    return {"stages": 4, "stage_seconds": 40.0,
            "fractions": {"compute": 0.12, "wait-act": 0.40, "wait-grad": 0.30,
                          "wire-blocked": 0.08, "ckpt": 0.05, "idle": 0.05},
            "bubble_fraction": 0.88, "wait_fraction": 0.88}


def test_bench_bubble_attribution_schema_accepts_good_record():
    assert bench_all.check_bubble_attribution(_good_attr()) == _good_attr()
    assert bench_all.BUBBLE_STATES == _jax_bench().BUBBLE_STATES


@pytest.mark.parametrize("mutate, msg", [
    (lambda a: a.pop("fractions"), "fractions"),
    (lambda a: a["fractions"].update({"napping": 0.5}), "unknown state"),
    (lambda a: a["fractions"].update({"idle": 0.5}), "sum"),
    (lambda a: a.update(bubble_fraction=1.5), "not in [0, 1]"),
    (lambda a: a.update(bubble_fraction=0.5), "1 - compute"),
    (lambda a: a.update(stages=0), "stages"),
    (lambda a: a.clear() or a.update(x=1), "fractions"),
])
def test_bench_bubble_attribution_schema_rejects_breaches(mutate, msg):
    attr = _good_attr()
    mutate(attr)
    with pytest.raises(ValueError) as mine:
        bench_all.check_bubble_attribution(attr)
    with pytest.raises(ValueError) as ref:
        _jax_bench().check_bubble_attribution(attr)
    assert msg.split()[0] in str(mine.value) and str(mine.value) == str(ref.value)


def test_bench_bubble_attribution_accepts_real_analyzer_output():
    bench_all.check_bubble_attribution(timeline.analyze(FIXTURES)["bubble_attribution"])
    with pytest.raises(ValueError, match="dict"):
        bench_all.check_bubble_attribution(None)
