"""The port's default model widths against the JAX package's, and the head
dims the port's attention kernels are built for.

The JAX entry points default to d_model 128 with 8 heads (head_dim 16). On
the card the port launches its attention kernels (K4-K6b, K8) for every
attention call, so every default width must have a head_dim those kernels
are built for, and the port's parsers must keep the JAX defaults.
"""

import inspect

import pytest

from distributed_ml_pytorch_tpu.serving import cli as jax_serving_cli
from distributed_ml_pytorch_tpu_torch import bench_all
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.ops import _build
from distributed_ml_pytorch_tpu_torch.ops import attention as tat
from distributed_ml_pytorch_tpu_torch.ops import decode_attention as tda
from distributed_ml_pytorch_tpu_torch.serving import cli as serving_cli
from distributed_ml_pytorch_tpu_torch.training import train_lm
from examples import train_lm as jax_train_lm

WIDTH_FLAGS = ("vocab", "d_model", "n_heads", "n_layers", "d_ff", "dtype", "pos_encoding")


def _defaults(parser):
    args = parser.parse_args([])
    return {name: getattr(args, name) for name in WIDTH_FLAGS}


@pytest.mark.parametrize("port,ref", [
    (serving_cli.build_parser, jax_serving_cli.build_parser),
    (train_lm.build_parser, jax_train_lm.build_parser),
], ids=["serving", "train_lm"])
def test_parser_width_defaults_match_jax(port, ref):
    assert _defaults(port()) == _defaults(ref())


def _transformer_default():
    sig = inspect.signature(TransformerLM.__init__).parameters
    return sig["d_model"].default, sig["n_heads"].default


DEFAULT_WIDTHS = {
    "serving_cli": lambda: (serving_cli.parse_args([]).d_model,
                            serving_cli.parse_args([]).n_heads),
    "train_lm": lambda: (train_lm.parse_args([]).d_model, train_lm.parse_args([]).n_heads),
    "TransformerLM()": _transformer_default,
    "gpt2_small": lambda: (bench_all.GPT2_SMALL["d_model"], bench_all.GPT2_SMALL["n_heads"]),
}


@pytest.mark.parametrize("which", sorted(DEFAULT_WIDTHS))
def test_default_head_dim_is_built_into_every_attention_kernel(which):
    d_model, n_heads = DEFAULT_WIDTHS[which]()
    head_dim = d_model // n_heads
    assert head_dim in tat.KERNEL_HEAD_DIMS, (which, head_dim)
    assert head_dim in tda.KERNEL_HEAD_DIMS, (which, head_dim)


def test_kernel_head_dims_agree_between_the_attention_modules():
    assert tat.KERNEL_HEAD_DIMS == tda.KERNEL_HEAD_DIMS == (16, 32, 64, 128)


def test_build_dir_hashes_the_shared_headers(tmp_path, monkeypatch):
    # an edited header must not load a library built from the old one
    (tmp_path / "k.cu").write_text('#include "frag.cuh"\n')
    header = tmp_path / "frag.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.build_dir()
    assert _build.build_dir() == first
    header.write_text("// v2\n")
    assert _build.build_dir() != first
    assert [p.name for p in _build._sources()] == ["k.cu"]


def test_the_mpmd_scenario_width_is_built_into_the_float32_kernels():
    """The MPMD scenario keeps the JAX scenario's widths (d_model 16 over 2
    heads) and runs float32: its head_dim 8 is one the float32 attention
    kernels are built for, so ``coord.cli --mpmd`` runs on the card."""
    from distributed_ml_pytorch_tpu_torch.coord.stages import scenario_cfg

    cfg = scenario_cfg()
    assert (cfg.vocab_size, cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff,
            cfg.max_len) == (32, 16, 2, 4, 32, 64)
    assert cfg.d_model // cfg.n_heads in tat.FLOAT32_HEAD_DIMS
    assert tat.FLOAT32_HEAD_DIMS == (8, *tat.KERNEL_HEAD_DIMS)
