"""The port's ResNets (``models/resnet.py``) against the JAX package's, on
the CPU, from carried weights (``utils/interop.py``); inputs from numpy.

Tolerances:
- float32 logits within 1e-5 absolute and relative (both run float32
  convolutions on the CPU, summing in other orders; measured 3.1e-6 at
  ResNet-50's logits of about 4);
- bfloat16 logits within 2^-4 of the largest logit: each of up to 50 layers
  rounds its output to bfloat16 (u = 2^-8) after summing in its own order,
  so a rounding can land one step apart at each and the difference
  compounds (measured 0.8 % at ResNet-50 at 72 x 72, 0.2 % at ResNet-18);
- the flat vector and the parameter count exactly;
- three SGD steps of ResNet-18 in float32 at lr 0.001: losses within 1e-4
  relative and the parameters within 1e-4 relative and 1e-5 absolute of
  JAX's. flax's GroupNorm takes the variance as E[x²] - E[x]² and torch's
  in two passes, which moves each normalised value in its last bits; the
  first loss agrees to 4e-7, the third (after two updates through the
  backward of 21 such layers) to 1.7e-5.
  (At lr 0.01 this batch's loss rises by the third step, and there the
  two packages' last-bit differences grow to 7e-4: the test holds the
  step where training is stable.)

The weights are drawn with numpy into the shapes of the flax tree (traced
abstractly, not initialised), then carried to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from distributed_ml_pytorch_tpu.models.resnet import get_resnet as jresnet
from distributed_ml_pytorch_tpu.training.trainer import TrainState as JTrainState
from distributed_ml_pytorch_tpu.training.trainer import build_tx as jbuild_tx
from distributed_ml_pytorch_tpu.training.trainer import make_train_step as jstep
from distributed_ml_pytorch_tpu.utils.serialization import ravel_model_params as jravel
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.models.resnet import get_resnet
from distributed_ml_pytorch_tpu_torch.training.trainer import (
    SGD,
    create_train_state,
    make_train_step,
)
from distributed_ml_pytorch_tpu_torch.utils import interop
from distributed_ml_pytorch_tpu_torch.utils.serialization import (
    flat_size,
    leaf_order,
    ravel_model_params,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2.0 ** -4
_PARAMS = {}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _jax_params(name, size):
    """A flax param tree of ``name`` for ``size``-row inputs (cached): the
    shapes from ``init`` traced abstractly, the values from numpy — kernels
    at lecun scale, GroupNorm scales about 1, biases about 0."""
    if (name, size) not in _PARAMS:
        shapes = jax.eval_shape(jresnet(name).init, jax.random.key(0),
                                jnp.zeros((1, size, size, 3)))["params"]
        rng = np.random.default_rng(len(name) + size)

        def draw(path, s):
            leaf = path[-1].key
            if leaf == "kernel":
                fan_in = int(np.prod(s.shape[:-1]))
                return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
            base = 1.0 if leaf == "scale" else 0.0
            return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

        _PARAMS[name, size] = jax.tree_util.tree_map_with_path(draw, shapes)
    return _PARAMS[name, size]


def _carried(name, size, dtype=torch.float32):
    tree = _jax_params(name, size)
    model = get_model(name, device="cpu", dtype=dtype, input_size=size)
    model.load_state_dict(interop.params_from_jax(tree, model))
    return tree, model


@pytest.mark.parametrize("name,size,dtype", [
    ("resnet18", 32, "float32"), ("resnet18", 32, "bfloat16"), ("resnet18", 72, "float32"),
    ("resnet50", 32, "float32"), ("resnet50", 32, "bfloat16"), ("resnet50", 72, "bfloat16")])
def test_forward_matches_jax(name, size, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tree, model = _carried(name, size, tdt)
    x = _images(2, size)
    ref = np.asarray(jax.jit(jresnet(name, dtype=jdt).apply)({"params": tree}, x))
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, 10)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
    else:
        assert np.abs(out.numpy() - ref).max() <= BF16_REL * np.abs(ref).max()


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50", "resnet101"])
@pytest.mark.parametrize("size", [32, 224])
def test_parameter_count_equals_jax(name, size):
    shapes = jax.eval_shape(jresnet(name, num_classes=1000).init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3)))["params"]
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    model = get_resnet(name, num_classes=1000, input_size=size)
    assert flat_size(model) == want
    assert model.stem == ("cifar" if size == 32 else "imagenet")


@pytest.mark.parametrize("name,size", [("resnet18", 32), ("resnet50", 32), ("resnet18", 72)])
def test_flat_vector_bit_identical_to_jax(name, size):
    tree, model = _carried(name, size)
    flat = ravel_model_params(model).numpy()
    np.testing.assert_array_equal(flat, np.asarray(jravel(tree)))
    if (name, size) == ("resnet18", 32):
        assert flat.size == 11_173_962


def test_resnet101_flat_order_sorts_block_names_as_strings():
    """``ravel_pytree`` sorts ``stage3_block10`` before ``stage3_block2``; a
    tree of distinct values ravels to the same bytes on both sides."""
    shapes = jax.eval_shape(jresnet("resnet101").init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(7)
    tree = jax.tree.map(lambda s: rng.random(s.shape, dtype=np.float32), shapes)
    model = get_resnet("resnet101")
    model.load_state_dict(interop.params_from_jax(tree, model))
    np.testing.assert_array_equal(ravel_model_params(model).numpy(),
                                  np.asarray(ravel_pytree(tree)[0]))
    stage3 = [name for name, _ in leaf_order(model) if name.startswith("stage3_")]
    blocks = list(dict.fromkeys(n.split(".")[0] for n in stage3))
    assert blocks[:4] == ["stage3_block1", "stage3_block10", "stage3_block11",
                          "stage3_block12"]
    assert leaf_order(model)[:2] == [("classifier", "bias"), ("classifier", "dense")]
    assert leaf_order(model)[-2:] == [("stem_norm", "bias"), ("stem_norm", "scale")]
    inner = [kind for n, kind in leaf_order(model) if n.startswith("stage1_block1.")]
    names = [n for n, _ in leaf_order(model) if n.startswith("stage1_block1.")]
    assert names == ["stage1_block1." + m for m in (
        "conv1", "conv2", "conv3", "downsample", "norm1", "norm1", "norm2", "norm2",
        "norm3", "norm3", "norm_down", "norm_down")]
    assert inner[4:6] == ["bias", "scale"]


def test_params_to_jax_round_trips_the_nested_tree():
    tree, model = _carried("resnet18", 32)
    back = interop.params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bad = dict(tree)
    bad["stage9_block1"] = bad["stage1_block1"]
    with pytest.raises(ValueError, match="stage9_block1"):
        interop.params_from_jax(bad, model)


def test_three_sgd_steps_match_jax():
    tree, model = _carried("resnet18", 32)
    x = _images(4, 32, seed=1)
    y = (np.arange(4) % 10).astype(np.int32)
    jmodel = jresnet("resnet18")
    tx = jbuild_tx("sgd", 0.001, 0.0, None, 0.0, 1)
    state = JTrainState.create(jax.tree.map(jnp.asarray, tree), tx)
    step = jstep(jmodel, tx)
    jlosses = []
    for _ in range(3):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y), jax.random.key(1))
        jlosses.append(float(loss))
    tx_t = SGD(0.001)
    tstate = create_train_state(model, tx_t)
    tstep = make_train_step(model, tx_t)
    losses = [float(tstep(tstate, torch.from_numpy(x), torch.from_numpy(y).long())[1])
              for _ in range(3)]
    assert jlosses[-1] < jlosses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(ravel_model_params(model).numpy(),
                               np.asarray(jravel(state.params)), rtol=1e-4, atol=1e-5)


def test_stem_is_fixed_at_construction():
    model = get_model("resnet18", device="cpu")  # input_size 32: the CIFAR stem
    assert model.stem_conv.kernel_size == (3, 3)
    with pytest.raises(ValueError, match="imagenet stem"):
        model(torch.zeros(1, 72, 72, 3))
    explicit = get_model("resnet18", device="cpu", stem="imagenet")
    assert explicit.stem_conv.kernel_size == (7, 7)
    assert explicit(torch.zeros(1, 32, 32, 3)).shape == (1, 10)
    with pytest.raises(ValueError):
        get_model("resnet1000", device="cpu")
    with pytest.raises(ValueError):
        get_model("resnet18", device="cpu", stem="tiny")


def test_cli_trains_resnet18_and_offers_resnet50(tmp_path):
    """``--model resnet18`` through the single trainer (the CIFAR stem, the
    CSV written); ``resnet50`` is offered to the DownPour ``ps`` mode and
    to the coordinator, which sizes its shard map by the flat vector."""
    from distributed_ml_pytorch_tpu_torch.coord import cli as coord_cli
    from distributed_ml_pytorch_tpu_torch.training import cli

    assert cli.main(["--no-distributed", "--backend", "cpu", "--model", "resnet18",
                     "--synthetic-data", "--synthetic-train-size", "16",
                     "--synthetic-test-size", "8", "--batch-size", "4", "--epochs", "1",
                     "--lr", "0.001", "--log-interval", "100",
                     "--log-dir", str(tmp_path)]) == 0
    assert (tmp_path / "single.csv").exists()
    assert cli.build_parser().parse_args(["--mode", "ps", "--model", "resnet50"]).model \
        == "resnet50"
    args = coord_cli.build_parser().parse_args(["--model", "resnet18"])
    assert coord_cli._n_params(args) == 11_173_962
