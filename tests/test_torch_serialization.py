"""The port's flat wire layout against the JAX package's ``ravel_pytree``.

A push, a pull reply and the server's central vector are this vector, so a
model carried across with ``params_from_jax`` must ravel to exactly the
bytes the JAX package ravels the same flax params to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from distributed_ml_pytorch_tpu.models import AlexNet as JAlexNet
from distributed_ml_pytorch_tpu.models import LeNet as JLeNet
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.utils import interop
from distributed_ml_pytorch_tpu_torch.utils.serialization import (
    flat_size,
    leaf_order,
    make_unraveler,
    ravel_model_params,
    unravel_model_params,
)

MODELS = {"alexnet": JAlexNet, "lenet": JLeNet}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _carried(name, seed=0):
    jparams = MODELS[name]().init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)))["params"]
    tree = jax.tree.map(np.asarray, jparams)
    model = get_model(name, device="cpu")
    model.load_state_dict(interop.params_from_jax(tree, model))
    return jparams, tree, model


@pytest.mark.parametrize("name", ["alexnet", "lenet"])
def test_ravel_bit_identical_to_ravel_pytree(name):
    jparams, _tree, model = _carried(name)
    ref = np.asarray(ravel_pytree(jparams)[0])
    flat = ravel_model_params(model)
    np.testing.assert_array_equal(flat.numpy(), ref)
    assert flat_size(model) == ref.size
    if name == "alexnet":
        assert ref.size == 2_472_266


def test_leaf_order_is_sorted_with_bias_first():
    model = get_model("alexnet", device="cpu")
    assert leaf_order(model)[:4] == [("classifier", "bias"), ("classifier", "dense"),
                                     ("conv1", "bias"), ("conv1", "conv")]


@pytest.mark.parametrize("name", ["alexnet", "lenet"])
def test_unravel_round_trip_and_jax_unravel_agree(name):
    jparams, _tree, model = _carried(name)
    rng = np.random.default_rng(1)
    flat = rng.normal(size=flat_size(model)).astype(np.float32)
    unravel_model_params(model, torch.from_numpy(flat))
    np.testing.assert_array_equal(ravel_model_params(model).numpy(), flat)
    # the same vector means the same parameters on both sides
    jtree = jax.tree.map(np.asarray, ravel_pytree(jparams)[1](jnp.asarray(flat)))
    back = interop.params_to_jax(model)
    for layer, leaves in jtree.items():
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf], arr)
    values = make_unraveler(model)(torch.from_numpy(flat))
    for pname, p in model.named_parameters():
        assert torch.equal(values[pname], p.detach())


def test_params_to_jax_inverts_params_from_jax():
    _jp, tree, model = _carried("lenet", seed=3)
    back = interop.params_to_jax(model)
    for layer, leaves in tree.items():
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf], arr)


def test_bad_sizes_raise():
    _jp, tree, model = _carried("lenet")
    with pytest.raises(ValueError):
        make_unraveler(model)(torch.zeros(10))
    bad = dict(tree)
    bad["fc9"] = bad["fc1"]
    with pytest.raises(ValueError):
        interop.params_from_jax(bad, model)
    with pytest.raises(ValueError):
        interop.params_from_jax(tree, get_model("alexnet", device="cpu"))
