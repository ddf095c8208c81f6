"""The port's attention ops against the JAX package's, on the CPU.

The JAX side runs its Pallas flash kernels in interpret mode (blocks of
128); the port runs its plain versions (a CPU tensor's path) through the same
``torch.autograd.Function`` the CUDA kernels sit in. Inputs come from numpy.

Tolerances (float32): 1e-5 absolute and relative on outputs and lse, 1e-4
on gradients. The two sides compute the same function with sums in other
orders: the JAX kernel folds key blocks one at a time with an online max,
the plain version takes each row's max at once. The bfloat16 cases (each
head_dim the kernels are built for, causal and not, fused and split
backward) are held to 2e-2: both
sides round p and dS to bfloat16, but against different running maxima, so
individual roundings differ by one bfloat16 step. The ctypes argument lists
are held to the C signatures they call.
Without JAX, the plain versions' own bfloat16 roundings are held within
2^-7 of each output's absolute product (``flash_error_scales``), the scale
the card's kernels are held at.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.ops import attention as ja
from distributed_ml_pytorch_tpu_torch.ops import attention as ta

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arrays(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _jflash(causal, bwd_impl, with_lse=False, dtype=jnp.float32):
    fn = ja.flash_attention_lse if with_lse else ja.flash_attention
    f = functools.partial(fn, causal=causal, interpret=True, block_q=128, block_k=128,
                          bwd_impl=bwd_impl)
    return lambda q, k, v: f(q.astype(dtype), k.astype(dtype), v.astype(dtype))


def _jvjp(fn, q, k, v, ct):
    """``(fn(q, k, v), vjp(ct))`` under one jit (interpret mode runs far
    faster compiled than eagerly)."""

    def both(q, k, v, ct):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(ct)

    return jax.jit(both)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ct)


def _t(a, dtype=torch.float32, grad=True):
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bwd_impl", ["fused", "split"])
def test_flash_attention_forward_and_grads_match_jax(causal, bwd_impl):
    shape = (1, 2, 256, 32)
    q, k, v, g = _arrays(shape, seed=3 + causal, n=4)
    jf = _jflash(causal, bwd_impl)
    out_ref, grads_ref = _jvjp(jf, q, k, v, jnp.asarray(g))
    qt, kt, vt = _t(q), _t(k), _t(v)
    out = ta.flash_attention(qt, kt, vt, causal=causal, block_q=128, block_k=128,
                             bwd_impl=bwd_impl)
    np.testing.assert_allclose(_np(out), np.asarray(out_ref), **OUT_TOL)
    out.backward(torch.from_numpy(g))
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads_ref):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("bwd_impl,lse_only", [("fused", False), ("split", False),
                                               ("fused", True)])
def test_flash_attention_lse_with_lse_cotangent_matches_jax(bwd_impl, lse_only):
    shape = (1, 2, 256, 64)
    q, k, v, g = _arrays(shape, seed=11, n=4)
    if lse_only:  # the out cotangent is absent: only the lse feeds the loss
        g = np.zeros_like(g)
    glse = np.random.default_rng(12).normal(size=shape[:3]).astype(np.float32)
    jf = _jflash(True, bwd_impl, with_lse=True)
    (out_ref, lse_ref), grads_ref = _jvjp(jf, q, k, v, (jnp.asarray(g), jnp.asarray(glse)))
    qt, kt, vt = _t(q), _t(k), _t(v)
    out, lse = ta.flash_attention_lse(qt, kt, vt, causal=True, bwd_impl=bwd_impl)
    np.testing.assert_allclose(_np(out), np.asarray(out_ref), **OUT_TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_ref), **OUT_TOL)
    if lse_only:
        lse.backward(torch.from_numpy(glse))
    else:
        torch.autograd.backward((out, lse), (torch.from_numpy(g), torch.from_numpy(glse)))
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads_ref):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **GRAD_TOL)


# (head_dim, causal, bwd_impl); the fused cases keep their ids "16-True", ...
_BF16_CASES = [(d, c, impl) for impl in ("fused", "split") for d in (16, 32, 64, 128)
               for c in (True, False)]


@pytest.mark.parametrize("head_dim,causal,bwd_impl", _BF16_CASES, ids=[
    f"{d}-{c}" + ("-split" if impl == "split" else "") for d, c, impl in _BF16_CASES])
def test_flash_attention_bf16_matches_jax(head_dim, causal, bwd_impl):
    # every head_dim the bfloat16 kernels (K4, K5, K6a, K6b) are built for,
    # the split backward held against the JAX split kernels
    shape = (1, 2, 256, head_dim)
    q, k, v, g = _arrays(shape, seed=21, n=4)
    jf = _jflash(causal, bwd_impl, dtype=jnp.bfloat16)
    out_ref, grads_ref = _jvjp(jf, q, k, v, jnp.asarray(g).astype(jnp.bfloat16))
    qt, kt, vt = (_t(a, torch.bfloat16) for a in (q, k, v))
    out = ta.flash_attention(qt, kt, vt, causal=causal, bwd_impl=bwd_impl)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), np.asarray(out_ref, np.float32), **BF16_TOL)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads_ref):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), **BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_with_offsets_matches_jax(causal):
    # 200 keys in blocks of 64: the padded last block is masked by position
    q, = _arrays((2, 2, 96, 32), seed=31, n=1)
    k, v = _arrays((2, 2, 200, 32), seed=32, n=2)
    kw = dict(causal=causal, block_k=64, q_offset=150, k_offset=40)
    ref = ja.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = ta.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw)
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(_np(g_), np.asarray(r_), **OUT_TOL)
    np.testing.assert_allclose(_np(ta.finalize_attention(got[0], got[2])),
                               np.asarray(ja.finalize_attention(ref[0], ref[2])), **OUT_TOL)


def test_reference_scan_and_auto_attention_match_jax():
    q, k, v = _arrays((2, 2, 128, 32), seed=41)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ref = np.asarray(ja.attention_reference(jq, jk, jv, causal=True))
    np.testing.assert_allclose(_np(ta.attention_reference(tq, tk, tv, causal=True)), ref,
                               **OUT_TOL)
    np.testing.assert_allclose(_np(ta.scan_attn_fn(tq, tk, tv)),
                               np.asarray(ja.scan_attn_fn(jq, jk, jv)), **OUT_TOL)
    # auto_attention: flash (plain) on a blockable shape, the scan otherwise
    np.testing.assert_allclose(_np(ta.auto_attention(tq, tk, tv)), ref, **OUT_TOL)
    ragged = [a[:, :, :100] for a in (q, k, v)]
    np.testing.assert_allclose(
        _np(ta.auto_attention(*map(torch.from_numpy, ragged))),
        np.asarray(ja.auto_attention(*map(jnp.asarray, ragged))), **OUT_TOL)


@pytest.mark.parametrize("n", [128, 256, 384, 640, 1024, 2048, 4096, 8192, 100, 96])
def test_block_choices_match_jax(n):
    assert ta._side_block_choice(n) == ja._side_block_choice(n)
    for sk in (n, 8192, 1000):
        assert ta.flash_block_choice(n, sk) == ja.flash_block_choice(n, sk)
        assert ta.flash_bwd_block_choice(n, sk) == ja.flash_bwd_block_choice(n, sk)


@pytest.mark.parametrize("shape,blocks", [
    ((8, 12, 2048, 64), {}),                                  # GPT-2-small: fused
    ((1, 12, 65536, 64), {}),                                 # past the cap: split
    ((1, 12, 32768, 128), {"block_k_bwd": 512}),              # cap via small key blocks
    ((2, 4, 1024, 64), {"bwd_impl": "split"}),                # explicit
])
def test_bwd_impl_selection_matches_jax(shape, blocks):
    jq = jax.ShapeDtypeStruct(shape, jnp.float32)
    tq = torch.empty(shape, device="meta")
    kw = dict(block_q=None, block_k=None, block_q_bwd=None, block_k_bwd=None, bwd_impl=None)
    kw.update(blocks)
    jblocks, jbwd, _interp, jimpl = ja._resolve_flash_config(
        jq, jq, True, kw["block_q"], kw["block_k"], kw["block_q_bwd"], kw["block_k_bwd"],
        True, kw["bwd_impl"])
    assert ta._resolve_flash_config(
        tq, tq, True, kw["block_q"], kw["block_k"], kw["block_q_bwd"], kw["block_k_bwd"],
        kw["bwd_impl"]) == (jblocks, jbwd, jimpl)


@pytest.mark.parametrize("qshape,kshape,kw", [
    ((1, 2, 256, 32), (1, 2, 128, 32), dict(causal=True)),       # causal needs sq == sk
    ((1, 2, 256, 32), (1, 2, 256, 32), dict(block_q=96)),        # block must divide
    ((1, 2, 100, 32), (1, 2, 100, 32), dict()),                  # no default blocking
    ((1, 2, 256, 32), (1, 2, 256, 32), dict(bwd_impl="both")),   # unknown bwd_impl
])
def test_flash_errors_match_jax(qshape, kshape, kw):
    q = np.zeros(qshape, np.float32)
    k = np.zeros(kshape, np.float32)
    with pytest.raises(ValueError) as jerr:
        ja.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), interpret=True, **kw)
    with pytest.raises(ValueError) as terr:
        ta.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k), **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("causal", [True, False])
def test_error_scales_bound_the_bf16_roundings(causal):
    # the plain versions on bfloat16 inputs round p (or dS) and the output,
    # at most u = 2^-8 each, so they sit within 2u of the absolute product
    # of the same function on the same values in float32, which rounds
    # neither; the card's kernels are held at 4u of it (two such sides)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _arrays((4, 192, 32), seed=11, n=4))
    f32 = [t.float() for t in (q, k, v, do)]
    out32, lse2 = ta.flash_fwd_plain(*f32[:3], causal)
    delta = (f32[3] * out32).sum(-1)
    args = (lse2, delta, causal)
    sc = ta.flash_error_scales(q, k, v, do, *args)
    assert {n: tuple(s.shape) for n, s in sc.items()} == {n: (4, 192, 32) for n in sc}
    got = dict(zip(("out", "dq", "dk", "dv"),
                   (ta.flash_fwd_plain(q, k, v, causal)[0],
                    *ta.flash_bwd_fused_plain(q, k, v, do, *args))))
    want = dict(zip(("out", "dq", "dk", "dv"),
                    (out32, *ta.flash_bwd_fused_plain(*f32, *args))))
    for name, g in got.items():
        err = (g.float() - want[name]).abs()
        assert g.dtype == torch.bfloat16
        assert bool((err <= 1e-6 + 2.0 ** -7 * sc[name]).all()), name
        # and not far inside it: the bound is not slack by orders of magnitude
        assert float((err / sc[name].clamp_min(1e-30)).max()) > 2.0 ** -10, name


@pytest.mark.parametrize("head_dim", [16, 128])
def test_plain_dp_is_one_fma_chain_in_order_of_d(head_dim):
    # the plain backward's dP: f32 terms added in order of d, each rounded
    # once (a bfloat16 product is exact in f32), as the kernels' FMA chains
    rng = np.random.default_rng(head_dim)
    do, v = (torch.from_numpy(rng.normal(size=(2, 5, head_dim)).astype(np.float32))
             .to(torch.bfloat16) for _ in range(2))
    a, b = do.float().numpy(), v.float().numpy()
    want = np.zeros((2, 5, 5), np.float32)
    for i in range(head_dim):
        want = want + a[:, :, None, i] * b[:, None, :, i]
    assert want.dtype == np.float32
    np.testing.assert_array_equal(ta._dp_in_order(do, v).numpy(), want)


_SOURCES = ("attention.cu", "flash_fwd_tc.cu", "flash_bwd_tc.cu")


def _c_signatures():
    """``{entry point: (pointers, ints, floats)}`` of every ``extern "C" int
    dmt_flash_*`` in the attention sources (``void* stream`` is a pointer)."""
    import pathlib
    import re

    csrc = pathlib.Path(ta.__file__).resolve().parent.parent / "csrc"
    sigs = {}
    for src in _SOURCES:
        text = (csrc / src).read_text()
        for name, params in re.findall(r'extern "C" int (dmt_flash_\w+)\(([^)]*)\)', text):
            kinds = [("ptr" if "*" in p else p.split()[-2]) for p in params.split(",")]
            sigs[name] = (kinds.count("ptr"), kinds.count("int"), kinds.count("float"))
    return sigs


@pytest.mark.parametrize("name", sorted(ta._ARGTYPES))
def test_ctypes_argtypes_match_the_c_signatures(name):
    # ctypes passes an undeclared or int-typed pointer as 32 bits: each entry
    # point's argtypes must count the C signature's pointers, ints and floats
    import ctypes

    sigs = _c_signatures()
    assert set(sigs) == set(ta._ARGTYPES)
    types = ta._argtypes(name)
    assert len(types) == sum(sigs[name])
    assert (types.count(ctypes.c_void_p), types.count(ctypes.c_int),
            types.count(ctypes.c_float)) == sigs[name]


def test_k5_numerics_bench_edits_match_the_kernel_source():
    # bench_k5_numerics builds its variants by rewriting these lines
    import pathlib

    from distributed_ml_pytorch_tpu_torch import bench_k5_numerics as bench

    src = (pathlib.Path(ta.__file__).resolve().parent.parent / "csrc"
           / "flash_bwd_tc.cu").read_text()
    for edits in bench.EDITS.values():
        for old, _new in edits:
            assert src.count(old) == 1, old


def test_cpu_path_launches_no_kernel():
    before = dict(ta.launches)
    q, k, v = (_t(a) for a in _arrays((1, 1, 128, 32), seed=5))
    ta.flash_attention(q, k, v, causal=True).sum().backward()
    ta.flash_attention(q, k, v, causal=True, bwd_impl="split").sum().backward()
    assert ta.launches == before
