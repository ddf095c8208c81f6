"""Checkpoints of a sharded state (``utils/checkpoint.ShardedCheckpointer``)
on the CPU thread mesh.

The bar, for each of ``train_lm``'s seven mesh modes and the CNN's ``--mode
fsdp``: a run resumed from its step-2 (CNN: step-4) checkpoint equals the
uninterrupted run bit for bit, in its losses and in the global tree it
saves at the end (parameters and optimizer state, gathered over the mesh).
The file holds the mode's global tree: the full model's parameters by name
at their global shapes (the seeded single-device model's names and shapes),
the mode and the mesh. A restore into another mode, or into a model of
other widths, raises ``ValueError`` naming both sides, and so does a
sharded checkpoint offered to an unsharded run and the reverse; a restore
into another mesh shape of the same mode reshards.
"""

import os

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu_torch.runtime.mesh import run_threaded
from distributed_ml_pytorch_tpu_torch.training import train_lm
from distributed_ml_pytorch_tpu_torch.utils.checkpoint import STATE_FILE

LM_WIDTHS = ["--device", "cpu", "--vocab", "64", "--d-model", "16", "--n-heads", "2",
             "--n-layers", "2", "--d-ff", "32", "--seq", "16", "--batch", "4"]

#: mode -> (world size, extra flags)
LM_MODES = {"sp": (2, ()), "ulysses": (2, ()), "fsdp": (2, ()), "tp": (2, ()),
            "pp": (2, ()), "moe": (2, ("--n-experts", "2")), "composite": (4, ())}


def _lm(mode, steps, *extra):
    world, flags = LM_MODES[mode]
    argv = ["--mode", mode, "--world-size", str(world), *LM_WIDTHS, *flags,
            "--steps", str(steps), *extra]
    runs = run_threaded(world, lambda w: train_lm.run(train_lm.parse_args(argv)))
    return runs[0]


def _cnn(*extra):
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import train_fsdp
    from distributed_ml_pytorch_tpu_torch.training import cli

    args = ["--mode", "fsdp", "--backend", "cpu", "--model", "lenet", "--synthetic-data",
            "--synthetic-train-size", "64", "--synthetic-test-size", "16", "--batch-size", "4",
            "--epochs", "1", "--momentum", "0.9", "--log-interval", "1000", *extra]
    runs = run_threaded(2, lambda w: train_fsdp(cli.build_parser().parse_args(args)))
    return runs[0][1].records


def _tree(directory, step):
    return torch.load(os.path.join(directory, str(step), STATE_FILE), weights_only=True)


def _flat(tree):
    """Every tensor of a payload, by path."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, torch.Tensor):
            out[prefix] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}.{k}", v)
    walk("", {"params": tree["params"], "opt": tree["opt_state"]})
    return out


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("mode", [*LM_MODES, "cnn-fsdp"])
def test_a_resumed_sharded_run_equals_the_uninterrupted_one(mode, tmp_path, capsys):
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    if mode == "cnn-fsdp":
        # 8 steps an epoch (64 images, 4 a rank); the cut run starts from step 4
        whole = _cnn("--ckpt-dir", full, "--ckpt-every", "4")
        os.makedirs(cut)
        os.rename(os.path.join(full, "4"), os.path.join(cut, "4"))
        resumed = _cnn("--ckpt-dir", cut, "--ckpt-every", "4", "--resume")
        assert "resumed from step 4" in capsys.readouterr().out
        assert [r["training_loss"] for r in resumed] == [
            r["training_loss"] for r in whole[4:]]
        step, expect = 8, "fsdp"
        from distributed_ml_pytorch_tpu_torch.models import get_model

        shapes = {n: list(p.shape) for n, p in get_model("lenet", device="cpu")
                  .named_parameters()}
    else:
        whole = _lm(mode, 4, "--ckpt-dir", full, "--ckpt-every", "4")
        first = _lm(mode, 2, "--ckpt-dir", cut, "--ckpt-every", "2")
        resumed = _lm(mode, 2, "--ckpt-dir", cut, "--ckpt-every", "2", "--resume")
        assert "resumed from checkpoint step 2" in capsys.readouterr().out
        assert resumed.start_step == 2 and first.losses == whole.losses[:2]
        assert resumed.losses == whole.losses[2:]
        step, expect = 4, mode
        if mode == "pp":
            from distributed_ml_pytorch_tpu_torch.parallel.pipeline import (
                PipelineLM,
                PipelineLMConfig,
            )

            ref = PipelineLM(PipelineLMConfig(vocab_size=64, d_model=16, n_heads=2, n_layers=2,
                                              d_ff=32, max_len=256))
        elif mode == "moe":
            from distributed_ml_pytorch_tpu_torch.models.moe import MoETransformerLM

            ref = MoETransformerLM(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                                   n_experts=2, max_len=256, device="cpu")
        else:
            ref = train_lm.build_model(train_lm.parse_args(LM_WIDTHS), "cpu")
        shapes = {n: list(p.shape) for n, p in ref.named_parameters()}
    a, b = _tree(full, step), _tree(cut, step)
    assert a["mode"] == b["mode"] == expect and a["step"] == b["step"] == step
    assert a["shapes"] == shapes
    _assert_trees_equal(a, b)


def test_a_restore_into_another_mode_or_model_raises(tmp_path):
    d = str(tmp_path / "ck")
    _lm("fsdp", 2, "--ckpt-dir", d, "--ckpt-every", "2")
    with pytest.raises(ValueError, match=r"--mode fsdp .*this run is --mode tp"):
        _lm("tp", 2, "--ckpt-dir", d, "--resume")
    with pytest.raises(ValueError, match=r"--mode fsdp.*this run is unsharded"):
        train_lm.run(train_lm.parse_args([*LM_WIDTHS, "--steps", "2", "--ckpt-dir", d,
                                          "--resume"]))
    wider = ["--d-ff", "64"]
    with pytest.raises(ValueError, match=r"--mode fsdp \(mesh \{'data': 2\}\).*shapes differ"):
        _lm("fsdp", 2, "--ckpt-dir", d, "--resume", *wider)
    single = str(tmp_path / "single")
    train_lm.run(train_lm.parse_args([*LM_WIDTHS, "--steps", "2", "--ckpt-dir", single]))
    with pytest.raises(ValueError, match=r"unsharded run's state; this run is --mode sp"):
        _lm("sp", 2, "--ckpt-dir", single, "--resume")


def test_a_restore_into_another_mesh_shape_reshards(tmp_path, capsys):
    """An fsdp checkpoint of two ranks resumes on four (the batch of 4
    split 4 ways), and its first loss is the two-rank run's next one
    within float32 reassociation."""
    d = str(tmp_path / "ck")
    two = _lm("fsdp", 4, "--ckpt-dir", str(tmp_path / "whole"), "--ckpt-every", "4")
    _lm("fsdp", 2, "--ckpt-dir", d, "--ckpt-every", "2")
    argv = ["--mode", "fsdp", "--world-size", "4", *LM_WIDTHS, "--steps", "2",
            "--ckpt-dir", d, "--resume"]
    four = run_threaded(4, lambda w: train_lm.run(train_lm.parse_args(argv)))[0]
    assert four.start_step == 2
    np.testing.assert_allclose(four.losses, two.losses[2:], rtol=1e-5)
    assert _tree(d, 4)["mesh"] == {"data": 4}
