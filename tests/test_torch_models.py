"""The port's LeNet and AlexNet against the JAX models, from carried weights.

Tolerance rtol 1e-5, atol 1e-5: both run float32 convolutions on the CPU
but sum the products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from distributed_ml_pytorch_tpu.models import AlexNet as JAlexNet
from distributed_ml_pytorch_tpu.models import LeNet as JLeNet
from distributed_ml_pytorch_tpu.training.trainer import cross_entropy_loss as jce
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.training.trainer import cross_entropy_loss
from distributed_ml_pytorch_tpu_torch.utils import interop
from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=n).astype(np.int32))


def _pair(jmodel, name, fused=False):
    jparams = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    model = get_model(name, fused_epilogue=fused, device="cpu")
    model.load_state_dict(interop.params_from_jax(jax.tree.map(np.asarray, jparams), model))
    return jparams, model


@pytest.mark.parametrize("fused", [False, True])
def test_alexnet_logits_and_grads_match_jax(fused):
    jmodel = JAlexNet(fused_epilogue=fused)
    jparams, model = _pair(jmodel, "alexnet", fused)
    x, y = _batch()

    def loss_fn(p):
        return jce(jmodel.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    logits_ref = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x)))
    model.train()
    logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), logits_ref, **TOL)
    loss = cross_entropy_loss(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    np.testing.assert_allclose(ravel_model_params(model, grads=True).numpy(),
                               np.asarray(ravel_pytree(jgrads)[0]), **TOL)


def test_lenet_eval_logits_match_jax():
    jparams, model = _pair(JLeNet(), "lenet")
    x, _ = _batch(3, seed=1)
    ref = np.asarray(JLeNet().apply({"params": jparams}, jnp.asarray(x), train=False))
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_get_model_is_seeded_and_channels_last():
    a = get_model("alexnet", seed=5, device="cpu")
    b = get_model("alexnet", seed=5, device="cpu")
    assert torch.equal(ravel_model_params(a), ravel_model_params(b))
    assert a.conv2.weight.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        get_model("resnet18", device="cpu")


def test_lenet_dropout_uses_the_given_generator():
    model = get_model("lenet", device="cpu")
    model.train()
    x, _ = _batch(2)
    xt = torch.from_numpy(x)
    a = model(xt, generator=torch.Generator().manual_seed(1))
    b = model(xt, generator=torch.Generator().manual_seed(1))
    c = model(xt, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
