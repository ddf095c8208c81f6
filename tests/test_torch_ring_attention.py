"""Ring attention (``parallel/ring.py``) of the port on worlds of threads, case
for case as the JAX package's ``tests/test_ring_attention.py`` on its
8-device virtual CPU mesh, from the same seeded numpy inputs.

Against the JAX ring (``make_ring_attention`` under ``shard_map``; its
flash impl in Pallas interpret mode): the blockwise impl at the JAX test's
bounds, atol 2e-5 / rtol 1e-4 on the output and atol 5e-5 / rtol 1e-3 on
the gradients; the flash impl (the plain versions of K4/K5 on the CPU)
atol 2e-4 / rtol 1e-3 and atol 5e-4 / rtol 5e-3 (the JAX test's). Three
cases of the port's own: a future chunk launches no kernel (rank ``i`` of
a causal ring runs ``i + 1`` chunks forward and backward), ranks that skip
different numbers of chunks all finish the backward, and the lse
cotangent of ``flash_attention_lse`` reaches the backward as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.ops import attention_reference
from distributed_ml_pytorch_tpu.ops.attention import flash_attention_lse as jflash_lse
from distributed_ml_pytorch_tpu.parallel.ring import make_ring_attention as jmake_ring
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh as jmake_mesh
from distributed_ml_pytorch_tpu_torch.ops import attention as at
from distributed_ml_pytorch_tpu_torch.parallel import ring
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded

P = 8  # the JAX test's seq mesh
OUT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)
FLASH_OUT_TOL = dict(atol=2e-4, rtol=1e-3)
FLASH_GRAD_TOL = dict(atol=5e-4, rtol=5e-3)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def seq_mesh():
    return jmake_mesh({"seq": P}, devices=jax.devices()[:P])


def _qkv(b=2, h=2, s=256, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(3))


def _port_ring(q, k, v, causal, grad=False, p=P, **kw):
    """The port's ring over a ``p``-thread world: the output (and, with
    ``grad``, the gradients of ``sum(out²)``) gathered in sequence order."""

    def rank(world):
        mesh = make_mesh({"seq": p}, world=world)
        ts = [torch.from_numpy(a).requires_grad_(grad) for a in (q, k, v)]
        out = ring.make_ring_attention(mesh, "seq", causal=causal, **kw)(*ts)
        i, c = mesh.axis_index("seq"), q.shape[2] // p
        grads = ()
        if grad:
            (out ** 2).sum().backward()
            grads = tuple(t.grad[:, :, i * c:(i + 1) * c] for t in ts)
        return (out.detach(),) + grads

    got = run_threaded(p, rank, timeout_s=120.0)
    return [torch.cat([r[j] for r in got], dim=2).numpy() for j in range(len(got[0]))]


def _jax_grads(fn, q, k, v):
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2), argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full(seq_mesh, causal):
    q, k, v = _qkv()
    want = np.asarray(jmake_ring(seq_mesh, "seq", causal=causal, block_k=16)(q, k, v))
    got = _port_ring(q, k, v, causal, block_k=16, impl="blockwise")[0]
    np.testing.assert_allclose(got, want, **OUT_TOL)
    ref = np.asarray(attention_reference(q, k, v, causal=causal))
    np.testing.assert_allclose(got, ref, **OUT_TOL)


def test_ring_attention_output_stays_sharded(seq_mesh):
    """Each rank returns its own ``(b, h, S/p, d)`` chunk of the output, the
    JAX output's ``P(None, None, 'seq', None)`` shard."""
    q, k, v = _qkv()
    want = np.asarray(jmake_ring(seq_mesh, "seq")(q, k, v))

    def rank(world):
        mesh = make_mesh({"seq": P}, world=world)
        return ring.make_ring_attention(mesh, "seq")(*(torch.from_numpy(a) for a in (q, k, v)))

    chunks = run_threaded(P, rank)
    c = q.shape[2] // P
    for i, out in enumerate(chunks):
        assert tuple(out.shape) == (2, 2, c, 32)
        np.testing.assert_allclose(out.numpy(), want[:, :, i * c:(i + 1) * c], **OUT_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_is_differentiable(seq_mesh, causal):
    q, k, v = _qkv(b=1, h=1, s=64, d=16)
    want = _jax_grads(jmake_ring(seq_mesh, "seq", causal=causal, block_k=8), q, k, v)
    got = _port_ring(q, k, v, causal, grad=True, block_k=8, impl="blockwise")[1:]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


@pytest.fixture(scope="module")
def flash_case(seq_mesh):
    """The JAX flash ring at the JAX tests' shapes: outputs at b2 h2 s1024
    d32, gradients at b1 h1 s1024 d16 (seed 3), causal and not."""
    out, grads = {}, {}
    q, k, v = _qkv(s=1024, d=32)
    for causal in (False, True):
        fn = jmake_ring(seq_mesh, "seq", causal=causal, impl="flash")
        out[causal] = np.asarray(fn(q, k, v))
    gq, gk, gv = _qkv(b=1, h=1, s=1024, d=16, seed=3)
    for causal in (False, True):
        fn = jmake_ring(seq_mesh, "seq", causal=causal, impl="flash")
        grads[causal] = [np.asarray(g) for g in _jax_grads(fn, gq, gk, gv)]
    return (q, k, v), out, (gq, gk, gv), grads


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_attention_matches_full(flash_case, causal):
    """The flash ring (chunk-level logsumexp fold) against the JAX flash
    ring and dense attention: s_local = 128, the least flash block."""
    (q, k, v), out, _, _ = flash_case
    got = _port_ring(q, k, v, causal, impl="flash")[0]
    np.testing.assert_allclose(got, out[causal], **FLASH_OUT_TOL)
    ref = np.asarray(attention_reference(q, k, v, causal=causal))
    np.testing.assert_allclose(got, ref, **FLASH_OUT_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_attention_is_differentiable(flash_case, causal):
    """Gradients through the flash ring against JAX's, whose chunk lse
    outputs carry cotangents into the kernel backward's delta."""
    _, _, (q, k, v), grads = flash_case
    got = _port_ring(q, k, v, causal, grad=True, impl="flash")[1:]
    for g, w in zip(got, grads[causal]):
        np.testing.assert_allclose(g, w, **FLASH_GRAD_TOL)


def test_ring_attention_long_context_smoke(seq_mesh):
    """8k tokens over 8 ranks — each rank only ever holds 1k of K/V."""
    q, k, v = _qkv(b=1, h=1, s=8192, d=32)
    got = _port_ring(q, k, v, True, block_k=256, impl="blockwise")[0]
    assert got.shape == (1, 1, 8192, 32) and np.isfinite(got).all()
    want = np.asarray(jmake_ring(seq_mesh, "seq", causal=True, block_k=256)(q, k, v))
    np.testing.assert_allclose(got, want, **OUT_TOL)


def test_a_future_chunk_launches_no_kernel(monkeypatch):
    """Rank i of a causal 4-rank flash ring holds i past-or-diagonal chunks
    plus one: its forward launches i + 1 chunk kernels and its backward as
    many (the plain versions stand in for K4/K5 on the CPU); the future
    chunks launch nothing, and so no causal ring launches p² chunks."""
    calls = {"fwd": {}, "bwd": {}}
    real_fwd, real_bwd = at.flash_fwd_plain, at.flash_bwd_fused_plain
    import threading

    def fwd(*a, **k):
        name = threading.current_thread().name
        calls["fwd"][name] = calls["fwd"].get(name, 0) + 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        name = threading.current_thread().name
        calls["bwd"][name] = calls["bwd"].get(name, 0) + 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(at, "flash_fwd_plain", fwd)
    monkeypatch.setattr(at, "flash_bwd_fused_plain", bwd)
    q, k, v = _qkv(b=1, h=1, s=512, d=16)
    _port_ring(q, k, v, True, grad=True, p=4, impl="flash")
    want = {f"rank{i}": i + 1 for i in range(4)}
    assert calls["fwd"] == want and calls["bwd"] == want
    assert [ring.chunk_case(1, src, True) for src in range(4)] == [
        ring.PAST, ring.DIAG, ring.FUTURE, ring.FUTURE]


def test_ranks_that_skip_different_chunks_finish_the_backward():
    """A causal 4-rank flash ring: rank 0 skips three chunks, rank 3 none;
    the hand-written reverse ring still pairs every hop (a world that hung
    would time out), and every rank's dQ, dK, dV equal the dense
    reference's."""
    q, k, v = _qkv(b=1, h=2, s=512, d=16, seed=5)
    got = _port_ring(q, k, v, True, grad=True, p=4, impl="flash")
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (at.attention_reference(*ts, causal=True) ** 2).sum().backward()
    for g, t in zip(got[1:], ts):
        np.testing.assert_allclose(g, t.grad.numpy(), **FLASH_GRAD_TOL)


def test_flash_lse_cotangent_matches_jax():
    """A loss of both outputs of ``flash_attention_lse`` (``sum(o²) +
    sum(lse·w)``): the lse cotangent folds into the backward's delta
    (``_Flash.backward``) as the JAX kernel folds it; gradients equal
    JAX's (its flash in interpret mode) at the flash bounds."""
    q, k, v = _qkv(b=1, h=2, s=256, d=16, seed=7)
    w = np.random.default_rng(8).normal(size=(1, 2, 256)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jflash_lse(q, k, v, causal=True, interpret=True)
        return jnp.sum(o ** 2) + jnp.sum(lse * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = at.flash_attention_lse(*ts, causal=True)
    ((o ** 2).sum() + (lse * torch.from_numpy(w)).sum()).backward()
    for t, wg in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), **FLASH_GRAD_TOL)


def test_a_chunk_no_flash_blocking_divides():
    """A 96-token chunk: ``impl=None`` on a CPU tensor is the blockwise ring,
    an explicit flash ring on the CPU refuses it, and its flash backward is
    the fused one (what a CUDA tensor runs, at any chunk length)."""
    q = torch.zeros(1, 2, 96, 16)
    assert ring._bwd_impl(q, q) == "fused"
    assert ring._pick_impl(q, q, None) == "blockwise"
    with pytest.raises(ValueError, match="no flash blocking"):
        ring._pick_impl(q, q, "flash")
