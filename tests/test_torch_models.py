"""The port's LeNet and AlexNet against the JAX models, from carried weights.

Float32: rtol 1e-5, atol 1e-5 — both run float32 convolutions on the CPU
but sum the products in different orders.

bfloat16 (``dtype=bfloat16`` over float32 parameters, unit roundoff u =
2^-8): both round each layer's output to bfloat16 at the same places, but
each sums a layer's products in its own order before rounding, so a
rounding can land one bfloat16 step apart at each of AlexNet's six layers
and the difference compounds. Each limit is about twice the gap measured
on this CPU: AlexNet's logits within 0.006 of the largest logit (measured
0.30 %), its loss within 4.5e-5 relative (2.2e-5), its gradients within a
relative L2 distance of 0.016 (0.81 %); LeNet's eval logits within 2^-9 of
the largest (measured 0). The same models computing in float32 miss every
one of these limits (AlexNet 0.74 %, 9.5e-5 and 6.8 %; LeNet 0.50 %), and a
function mode checks that every convolution and dense layer ran in
bfloat16, so the tests show that the computation is bfloat16's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree
from torch.overrides import TorchFunctionMode

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


def _pair(jmodel, name, fused=False, dtype=torch.float32):
    jparams = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    model = get_model(name, fused_epilogue=fused, device="cpu", dtype=dtype)
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
        get_model("vgg16", device="cpu")


def test_lenet_dropout_uses_the_given_generator():
    model = get_model("lenet", device="cpu")
    model.train()
    x, _ = _batch(2)
    xt = torch.from_numpy(x)
    a = model(xt, generator=torch.Generator().manual_seed(1))
    b = model(xt, generator=torch.Generator().manual_seed(1))
    c = model(xt, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


BF16_LOGITS, BF16_LOSS, BF16_GRADS, BF16_LENET = 0.006, 4.5e-5, 0.016, 2.0 ** -9


class _LayerDtypes(TorchFunctionMode):
    """Records the output dtype of every convolution and dense layer."""

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (F.conv2d, F.linear):
            self.dtypes.append(out.dtype)
        return out


def _layers(model):
    return sum(isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) for m in model.modules())


def _alexnet_gaps_to_jax_bf16(fused, dtype):
    """The port's AlexNet computing in ``dtype`` against JAX's bfloat16
    AlexNet from the same weights: the logits' max gap over the largest
    logit, the loss's relative gap and the gradients' relative L2 distance."""
    jmodel = JAlexNet(dtype=jnp.bfloat16, fused_epilogue=fused)
    jparams, model = _pair(jmodel, "alexnet", fused, dtype)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x, y = _batch(8)

    def loss_fn(p):
        return jce(jmodel.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    logits_ref = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x)))
    model.train()
    with _LayerDtypes() as seen:
        logits = model(torch.from_numpy(x))
    assert seen.dtypes == [dtype] * _layers(model)
    assert logits.dtype == torch.float32
    loss = cross_entropy_loss(logits, torch.from_numpy(y))
    loss.backward()
    g = ravel_model_params(model, grads=True).numpy()
    ref = np.asarray(ravel_pytree(jgrads)[0])
    return (np.abs(logits.detach().numpy() - logits_ref).max() / np.abs(logits_ref).max(),
            abs(float(loss.detach()) - float(jloss)) / abs(float(jloss)),
            np.linalg.norm(g - ref) / np.linalg.norm(ref))


def _lenet_eval_gap_to_jax_bf16(dtype):
    jparams, model = _pair(JLeNet(dtype=jnp.bfloat16), "lenet", dtype=dtype)
    x, _ = _batch(3, seed=1)
    ref = np.asarray(JLeNet(dtype=jnp.bfloat16).apply({"params": jparams}, jnp.asarray(x),
                                                      train=False))
    model.eval()
    with torch.no_grad(), _LayerDtypes() as seen:
        out = model(torch.from_numpy(x))
    assert seen.dtypes == [dtype] * _layers(model)
    assert out.dtype == torch.float32
    return np.abs(out.numpy() - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("fused", [False, True])
def test_alexnet_bf16_logits_and_grads_match_jax(fused):
    logits, loss, grads = _alexnet_gaps_to_jax_bf16(fused, torch.bfloat16)
    assert logits <= BF16_LOGITS and loss <= BF16_LOSS and grads <= BF16_GRADS, \
        (logits, loss, grads)


def test_lenet_bf16_eval_logits_match_jax():
    gap = _lenet_eval_gap_to_jax_bf16(torch.bfloat16)
    assert gap <= BF16_LENET, gap


@pytest.mark.parametrize("name", ["alexnet", "lenet"])
def test_float32_compute_misses_the_bf16_limits(name):
    """The limits above tell bfloat16 from float32: the same model
    computing in float32 lies outside each of them."""
    if name == "lenet":
        gap = _lenet_eval_gap_to_jax_bf16(torch.float32)
        assert gap > BF16_LENET, gap
    else:
        logits, loss, grads = _alexnet_gaps_to_jax_bf16(False, torch.float32)
        assert logits > BF16_LOGITS and loss > BF16_LOSS and grads > BF16_GRADS, \
            (logits, loss, grads)


def test_get_model_dtype():
    assert get_model("lenet", device="cpu", dtype="bfloat16").dtype == torch.bfloat16
    assert get_model("alexnet", device="cpu").dtype == torch.float32
    with pytest.raises(ValueError, match="bfloat16"):
        get_model("alexnet", device="cpu", dtype=torch.float16)
