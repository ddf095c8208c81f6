"""The port's ``bench_serving`` and ``examples/generate_text`` on the CPU:
the root scripts' flags and output (the JSON line's keys are read from the
root ``bench_serving.py``'s result literal), ``--tp`` with an indivisible degree refused, and
``--ckpt-dir`` restoring a ``train_lm`` checkpoint."""

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu_torch import bench_serving
from distributed_ml_pytorch_tpu_torch.examples import generate_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _root_tree(name):
    with open(os.path.join(ROOT, name)) as fh:
        return ast.parse(fh.read())


def _jax_result_keys():
    """The keys of the root ``bench_serving.main``'s ``result`` dict."""
    for node in ast.walk(_root_tree("bench_serving.py")):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no result dict in the root bench_serving.py")


def _flags(tree):
    return {a.value for node in ast.walk(tree) if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"
            for a in node.args if isinstance(a, ast.Constant)}


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_the_root_flags_and_defaults():
    port = {a.dest: a.default for a in bench_serving.build_parser()._actions}
    assert _flags(_root_tree("bench_serving.py")) | {"--backend"} == {
        a.option_strings[0] for a in bench_serving.build_parser()._actions
        if a.option_strings and a.option_strings[0] != "-h"}
    assert port["requests"] == 24 and port["rate"] == 8.0 and port["slots"] == 4
    assert port["backend"] == "cuda"
    # the port's own: --backend, and --dist-backend for --tp's world
    assert _flags(_root_tree("examples/generate_text.py")) | {"--backend", "--dist-backend"} == {
        a.option_strings[0] for a in generate_text.build_parser()._actions
        if a.option_strings and a.option_strings[0] != "-h"}


@pytest.mark.parametrize("argv", [
    [],
    ["--arrival", "herd", "--deadline-ms", "4000", "--priority-levels", "2"],
    ["--engines", "2", "--kill-engine-at", "0.2", "--arrival", "bursty"],
])
def test_bench_serving_emits_the_root_json_line(argv):
    rc, out = _run(bench_serving.main, ["--backend", "cpu", "--requests", "6", "--rate", "30",
                                        "--new-tokens", "4", "12", *argv])
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec)[:len(_jax_result_keys())] == _jax_result_keys()
    assert rec["platform"] == "cpu" and rec["device"] == "cpu"
    assert rec["metric"] == "serving_decode_throughput" and rec["value"] > 0
    assert rec["requests"] == 6 and rec["completed_in_slo"] <= 6
    if "--engines" in argv:
        assert rec["engines"] == 2 and rec["migrations"] >= 0


def test_arrival_mixes_are_the_root_scripts():
    """The four mixes draw the same arrival times as the root script's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("root_bench_serving",
                                                  os.path.join(ROOT, "bench_serving.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)  # imports no JAX at module level
    for mix in ("poisson", "diurnal", "bursty", "herd"):
        args = bench_serving.build_parser().parse_args(["--arrival", mix, "--requests", "40"])
        want = root.make_arrivals(args, np.random.default_rng(3))
        np.testing.assert_array_equal(
            bench_serving.make_arrivals(args, np.random.default_rng(3)), want)
        a, b = (m.make_plan(args, np.random.default_rng(4)) for m in (bench_serving, root))
        assert [(p["max_new_tokens"], list(p["prompt"])) for p in a] == [
            (p["max_new_tokens"], list(p["prompt"])) for p in b]


def test_generate_text_prints_the_root_lines():
    rc, out = _run(generate_text.main, ["--backend", "cpu", "--new-tokens", "17",
                                        "--batch", "2", "--kv-quant"])
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].startswith("decode (int8 KV cache): 34 tokens in ")
    assert [ln[:12] for ln in lines[1:]] == ["[0] prompt :", "[0] sampled:",
                                             "[1] prompt :", "[1] sampled:"]
    # the prompt is the root script's: default_rng(seed) over the vocabulary
    want = np.random.default_rng(0).integers(0, 512, size=(2, 32))
    assert lines[1].split(":")[1].split() == [str(t) for t in want[0]]
    assert len(lines[2].split(":")[1].split()) == 17


def test_generate_text_refuses_tp():
    # --tp is ported (tests/test_torch_generate_tp.py); a tp degree that
    # does not divide the heads (8) is what stays refused
    with pytest.raises(ValueError, match="not divisible"):
        generate_text.main(["--backend", "cpu", "--tp", "3"])


def test_generate_text_restores_a_train_lm_checkpoint(tmp_path):
    from distributed_ml_pytorch_tpu_torch.training import train_lm

    ck = str(tmp_path / "lm")
    with contextlib.redirect_stdout(io.StringIO()):
        train_lm.run(train_lm.parse_args(["--device", "cpu", "--steps", "2", "--ckpt-dir", ck,
                                          "--ckpt-every", "2"]))
    argv = ["--backend", "cpu", "--new-tokens", "5", "--batch", "1", "--ckpt-dir", ck]
    rc, out = _run(generate_text.main, argv)
    assert rc == 0 and f"restored params from step 2 of {ck}" in out
    fresh = _run(generate_text.main, argv[:-2])[1].splitlines()[-1]
    assert out.splitlines()[-1] != fresh  # the trained weights sample otherwise
    with pytest.raises(SystemExit, match="no checkpoint"):
        generate_text.main(["--backend", "cpu", "--ckpt-dir", str(tmp_path / "none")])
