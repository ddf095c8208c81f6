"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``gpu`` and skips without a card (decided in the
``cuda`` fixture, never at import). This file imports neither JAX nor the
JAX package, nor needs ``tests/conftest.py``, so it runs on a machine with
PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu_torch.ops import fused_conv as tfc
from distributed_ml_pytorch_tpu_torch.ops import fused_update as tfu

ALEXNET_PADDED = 2_472_320


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _vecs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 128, 1001, ALEXNET_PADDED])
@pytest.mark.parametrize("alpha", [1.0, -0.008, 0.37])
def test_flat_axpy_kernel_bit_identical(cuda, n, alpha):
    y, x = _vecs(n, seed=n)
    ref = tfu.flat_axpy_plain(torch.from_numpy(y.copy()), torch.from_numpy(x), alpha)
    yk, xk = torch.from_numpy(y).to(cuda), torch.from_numpy(x).to(cuda)
    before = tfu.launches
    out = tfu.flat_axpy(yk, xk, alpha)
    assert out is yk and tfu.launches == before + 1
    # views one element in: not 16-byte aligned, the scalar variant
    yo = torch.from_numpy(np.concatenate([[0.0], y]).astype(np.float32)).to(cuda)
    xo = torch.from_numpy(np.concatenate([[0.0], x]).astype(np.float32)).to(cuda)
    tfu.flat_axpy(yo[1:], xo[1:], alpha)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(yk.cpu().numpy(), ref.numpy())
    np.testing.assert_array_equal(yo[1:].cpu().numpy(), ref.numpy())


def _pool_inputs(shape, seed, ties):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2
    b = rng.normal(size=shape[-1]).astype(np.float32)
    pooled = (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    g = rng.integers(-4, 5, size=pooled).astype(np.float32)
    return x, b, g


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 8, 8, 64), (64, 4, 4, 192), (64, 2, 2, 256),
                                   (3, 6, 10, 5)])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_relu_pool2_kernels_match_plain(cuda, shape, ties, with_bias):
    x, b, g = _pool_inputs(shape, seed=1, ties=ties)
    xc = torch.from_numpy(x).to(cuda).requires_grad_(True)
    bc = torch.from_numpy(b).to(cuda).requires_grad_(True) if with_bias else None
    before = dict(tfc.launches)
    m = tfc.relu_pool2(xc, bc)
    m.backward(torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    route = "vector" if shape[-1] % 4 == 0 else "scalar"
    for k in ("relu_pool2_fwd", "relu_pool2_bwd", f"relu_pool2_fwd.{route}",
              f"relu_pool2_bwd.{route}"):
        assert tfc.launches[k] == before[k] + 1, k
    xr = torch.from_numpy(x).requires_grad_(True)
    br = torch.from_numpy(b).requires_grad_(True) if with_bias else None
    mr = tfc.relu_pool2(xr, br)
    mr.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(m.detach().cpu().numpy(), mr.detach().numpy())
    np.testing.assert_array_equal(xc.grad.cpu().numpy(), xr.grad.numpy())
    if with_bias:
        np.testing.assert_array_equal(bc.grad.cpu().numpy(), br.grad.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,misaligned,route", [
    ((1024, 8, 8, 64), False, "vector"), ((1024, 4, 4, 192), False, "vector"),
    ((1024, 2, 2, 256), False, "vector"), ((64, 4, 4, 37), False, "scalar"),
    ((64, 8, 8, 64), True, "scalar")])
@pytest.mark.parametrize("with_bias", [False, True])
def test_relu_pool2_routes_bit_identical(cuda, shape, misaligned, route, with_bias):
    # config 1's batch-1024 tails on the vector route; an odd C and a
    # contiguous view one element into its storage on the scalar route
    x, b, g = _pool_inputs(shape, seed=2, ties=True)
    if misaligned:
        xc = torch.empty(x.size + 1, device=cuda)[1:].view(shape)
        xc.copy_(torch.from_numpy(x))
        assert xc.is_contiguous() and xc.data_ptr() % 16 == 4
    else:
        xc = torch.from_numpy(x).to(cuda)
    bc = torch.from_numpy(b).to(cuda) if with_bias else None
    gc = torch.from_numpy(g).to(cuda)
    before = dict(tfc.launches)
    m = tfc.relu_pool2_fwd_cuda(xc, bc)
    dx = tfc.relu_pool2_bwd_cuda(xc, bc, m, gc)
    torch.cuda.synchronize()
    ran = {k: tfc.launches[k] - before[k] for k in before if k.startswith("relu_pool2")}
    other = "scalar" if route == "vector" else "vector"
    assert ran == {"relu_pool2_fwd": 1, "relu_pool2_bwd": 1,
                   f"relu_pool2_fwd.{route}": 1, f"relu_pool2_bwd.{route}": 1,
                   f"relu_pool2_fwd.{other}": 0, f"relu_pool2_bwd.{other}": 0,
                   **{k: 0 for k in ran if ".bf16" in k}}
    xr, br = torch.from_numpy(x), (torch.from_numpy(b) if with_bias else None)
    mr = tfc.relu_pool2_fwd_plain(xr, br)
    np.testing.assert_array_equal(m.cpu().numpy(), mr.numpy())
    np.testing.assert_array_equal(dx.cpu().numpy(),
                                  tfc.relu_pool2_bwd_plain(xr, br, mr, torch.from_numpy(g)).numpy())


@pytest.mark.gpu
def test_relu_pool2_rejects_non_contiguous(cuda):
    x = torch.randn(2, 4, 4, 8, device=cuda).permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfc.relu_pool2(x)


@pytest.mark.gpu
def test_alexnet_fused_and_unfused_steps_agree(cuda):
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        SGD,
        create_train_state,
        make_train_step,
    )
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    full_float32()
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(16, 32, 32, 3)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 10, size=16)).to(cuda)
    flats, losses = [], []
    for fused in (True, False):
        model = get_model("alexnet", fused_epilogue=fused, device=cuda)
        state = create_train_state(model, SGD(0.008))
        step = make_train_step(model, SGD(0.008))
        losses.append([float(step(state, x, y)[1]) for _ in range(3)])
        flats.append(ravel_model_params(model))
    assert losses[0] == losses[1]
    assert torch.equal(flats[0], flats[1])


# ------------------------------------------------------------------ attention

#: kernel vs plain version, as |kernel - plain| <= atol + rtol * scale, the
#: scale being |plain| or, kernel against plain version on the same inputs,
#: the output's absolute product (``attention.flash_error_scales``). float32:
#: the same function summed in other orders (online max, atomics for the
#: fused dQ). bfloat16 (unit roundoff u = 2^-8): p and dS round to bfloat16
#: against the kernel's running max in K4 and after other sums in K5/K6, at
#: most u of each term on each side, and each side rounds its output: 4u =
#: 2^-6 of the absolute product; atol is float32 summation noise (where
#: dS = p (dP - delta) cancels, both sides sum dP in order of d).
ATTN_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
            torch.bfloat16: dict(atol=1e-6, rtol=2.0 ** -6)}


def _attn_inputs(cuda, shape, dtype, seed, sk=None):
    bh, s, d = shape
    rng = np.random.default_rng(seed)
    mk = lambda n: torch.from_numpy(rng.normal(size=(bh, n, d)).astype(np.float32)).to(
        cuda, dtype)
    return mk(s), mk(sk or s), mk(sk or s), mk(s)


def _close(got, want, dtype, what, scale=None):
    tol = ATTN_TOL[dtype]
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    if scale is None:
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=what, **tol)
        return
    err = (g - w).abs()
    bad = err > tol["atol"] + tol["rtol"] * scale.cpu()
    assert not bool(bad.any()), (what, float(err.max()),
                                 float((err / scale.cpu().clamp_min(1e-30)).max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_match_plain(cuda, dtype, d, causal):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    q, k, v, do = _attn_inputs(cuda, (6, 256, d), dtype, seed=d + causal)
    before = dict(tat.launches)
    out, lse = tat.flash_fwd_cuda(q, k, v, causal)
    out_p, lse_p = tat.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * out_p.float()).sum(-1)
    dq_f, dk_f, dv_f = tat.flash_bwd_fused_cuda(q, k, v, do, lse_p, delta, causal)
    dq_s = tat.flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, causal)
    dk_s, dv_s = tat.flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, causal)
    dq_p, dk_p, dv_p = tat.flash_bwd_fused_plain(q, k, v, do, lse_p, delta, causal)
    sc = tat.flash_error_scales(q, k, v, do, lse_p, delta, causal)
    torch.cuda.synchronize()
    assert {n: tat.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_fused": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert out.dtype == dtype and dq_f.dtype == dtype and dk_s.dtype == dtype
    _close(out, out_p, dtype, "K4 out", sc["out"])
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(), rtol=1e-6, atol=1e-5)
    for name, got, want in (("K5 dq", dq_f, dq_p), ("K5 dk", dk_f, dk_p), ("K5 dv", dv_f, dv_p),
                            ("K6a dq", dq_s, dq_p), ("K6b dk", dk_s, dk_p),
                            ("K6b dv", dv_s, dv_p)):
        _close(got, want, dtype, name, sc[name[-2:]])


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_float32_kernels_take_head_dim_8(cuda, causal):
    """The float32 kernels (``csrc/attention.cu``) at head_dim 8, the JAX
    MPMD scenario's width, against their plain versions as at the other
    head dims; the bfloat16 tensor-core kernels refuse it."""
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    test_flash_kernels_match_plain(cuda, torch.float32, 8, causal)
    q, k, v, _do = _attn_inputs(cuda, (6, 256, 8), torch.bfloat16, seed=8)
    with pytest.raises(ValueError, match="bfloat16"):
        tat.flash_fwd_cuda(q, k, v, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,causal", [(200, 200, True), (200, 136, False), (64, 1, False)])
def test_flash_kernels_ragged_lengths(cuda, sq, sk, causal):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    q, k, v, do = _attn_inputs(cuda, (3, sq, 64), torch.float32, seed=sq + sk, sk=sk)
    out, _ = tat.flash_fwd_cuda(q, k, v, causal)
    out_p, lse_p = tat.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * out_p.float()).sum(-1)
    got = (*tat.flash_bwd_fused_cuda(q, k, v, do, lse_p, delta, causal),
           tat.flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, causal),
           *tat.flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, causal))
    dq_p, dk_p, dv_p = tat.flash_bwd_fused_plain(q, k, v, do, lse_p, delta, causal)
    _close(out, out_p, torch.float32, "out")
    for g, w in zip(got, (dq_p, dk_p, dv_p, dq_p, dk_p, dv_p)):
        _close(g, w, torch.float32, "grad")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(s, s, c) for s in (1, 63, 65, 200, 1000)
                                          for c in (True, False)]
                         + [(100, 300, False), (300, 100, False)])
def test_flash_fwd_tensor_core_kernel_matches_plain(cuda, d, sq, sk, causal):
    # the bfloat16 forward (flash_fwd_tc.cu): ragged tiles at both ends,
    # tiles wholly past sq, a single key, sq != sk
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    q, k, v, _ = _attn_inputs(cuda, (3, sq, d), torch.bfloat16, seed=sq + sk + d, sk=sk)
    before = dict(tat.launches)
    out, lse = tat.flash_fwd_cuda(q, k, v, causal)
    out_p, lse_p = tat.flash_fwd_plain(q, k, v, causal)
    scale = tat.flash_error_scales(q, k, v, q, lse_p, torch.zeros_like(lse_p), causal)["out"]
    torch.cuda.synchronize()
    assert tat.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _close(out, out_p, torch.bfloat16, "K4 out", scale)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(), rtol=1e-6, atol=1e-5)


@pytest.mark.gpu
def test_flash_fwd_tensor_core_kernel_rejects_misaligned(cuda):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    bh, s, d = 2, 128, 64
    q = torch.randn(bh, s, d, device=cuda).to(torch.bfloat16)
    # contiguous, but 2 bytes past a 16-byte boundary
    odd = torch.empty(bh * s * d + 1, device=cuda, dtype=torch.bfloat16)[1:].view(bh, s, d)
    odd.copy_(q)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    before = dict(tat.launches)
    for args in ((odd, q, q), (q, odd, q), (q, q, odd)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tat.flash_fwd_cuda(*args, True)
    assert tat.launches == before
    # float32 has no such requirement (the scalar kernel's element loads)
    odd32 = torch.empty(bh * s * d + 1, device=cuda)[1:].view(bh, s, d)
    odd32.copy_(q.float())
    tat.flash_fwd_cuda(odd32, odd32, odd32, True)
    torch.cuda.synchronize()
    assert tat.launches["flash_fwd"] == before["flash_fwd"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(s, s, c) for s in (1, 63, 65, 200, 1000)
                                          for c in (True, False)]
                         + [(100, 300, False), (300, 100, False)])
def test_flash_bwd_tensor_core_kernel_matches_plain(cuda, d, sq, sk, causal):
    # the bfloat16 fused backward (flash_bwd_tc.cu): ragged query and key
    # tiles (zero-filled rows masked by position), a single query, sq != sk
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    q, k, v, do = _attn_inputs(cuda, (3, sq, d), torch.bfloat16, seed=sq + sk + d, sk=sk)
    out_p, lse_p = tat.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, causal)
    before = dict(tat.launches)
    got = tat.flash_bwd_fused_cuda(*args)
    want = tat.flash_bwd_fused_plain(*args)
    sc = tat.flash_error_scales(*args)
    torch.cuda.synchronize()
    assert {n: tat.launches[n] - before[n] for n in before} == {
        "flash_fwd": 0, "flash_bwd_fused": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert bool(torch.isfinite(g.float()).all()), name
        _close(g, w, torch.bfloat16, f"K5 {name}", sc[name])


@pytest.mark.gpu
def test_flash_bwd_tensor_core_kernel_rejects_misaligned(cuda):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    bh, s, d = 2, 128, 64
    q = torch.randn(bh, s, d, device=cuda).to(torch.bfloat16)
    lse = torch.zeros(bh, s, device=cuda)
    # contiguous, but 2 bytes past a 16-byte boundary
    odd = torch.empty(bh * s * d + 1, device=cuda, dtype=torch.bfloat16)[1:].view(bh, s, d)
    odd.copy_(q)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    before = dict(tat.launches)
    for i, name in enumerate(("q", "k", "v", "do")):
        args = [q, q, q, q]
        args[i] = odd
        with pytest.raises(ValueError, match=f"{name} must be 16-byte aligned"):
            tat.flash_bwd_fused_cuda(*args, lse, lse, True)
    assert tat.launches == before
    # float32 has no such requirement (the scalar kernel's element loads)
    odd32 = torch.empty(bh * s * d + 1, device=cuda)[1:].view(bh, s, d)
    odd32.copy_(q.float())
    out, lse2 = tat.flash_fwd_cuda(odd32, odd32, odd32, True)
    delta = (odd32 * out).sum(-1)
    got = tat.flash_bwd_fused_cuda(odd32, odd32, odd32, odd32, lse2, delta, True)
    torch.cuda.synchronize()
    assert tat.launches["flash_bwd_fused"] == before["flash_bwd_fused"] + 1
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(s, s, c) for s in (100, 1000) for c in (True, False)]
                         + [(256, 256, True), (100, 300, False), (300, 100, False)])
def test_flash_dkv_tensor_core_kernel_is_k5_without_dq(cuda, d, sq, sk, causal):
    # the bfloat16 split dK/dV (K6b, flash_bwd_tc.cu's dQ-free kernel): the
    # same products in the same order as K5, so dK and dV equal K5's bit for
    # bit, and within the bound of the plain version; ragged query tiles
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    q, k, v, do = _attn_inputs(cuda, (3, sq, d), torch.bfloat16, seed=sq + 7 * sk + d, sk=sk)
    out_p, lse_p = tat.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, causal)
    before = dict(tat.launches)
    dk, dv = tat.flash_bwd_dkv_cuda(*args)
    _dq, dk5, dv5 = tat.flash_bwd_fused_cuda(*args)
    want = tat.flash_bwd_fused_plain(*args)
    sc = tat.flash_error_scales(*args)
    torch.cuda.synchronize()
    assert {n: tat.launches[n] - before[n] for n in before} == {
        "flash_fwd": 0, "flash_bwd_fused": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 1}
    assert dk.dtype == dv.dtype == torch.bfloat16 and dk.shape == k.shape
    assert torch.equal(dk, dk5) and torch.equal(dv, dv5)
    for name, g, w in (("dk", dk, want[1]), ("dv", dv, want[2])):
        assert bool(torch.isfinite(g.float()).all()), name
        _close(g, w, torch.bfloat16, f"K6b {name}", sc[name])


@pytest.mark.gpu
def test_flash_dkv_tensor_core_kernel_rejects_misaligned(cuda):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    bh, s, d = 2, 128, 64
    q = torch.randn(bh, s, d, device=cuda).to(torch.bfloat16)
    lse = torch.zeros(bh, s, device=cuda)
    odd = torch.empty(bh * s * d + 1, device=cuda, dtype=torch.bfloat16)[1:].view(bh, s, d)
    odd.copy_(q)
    before = dict(tat.launches)
    for i, name in enumerate(("q", "k", "v", "do")):
        args = [q, q, q, q]
        args[i] = odd
        with pytest.raises(ValueError, match=f"{name} must be 16-byte aligned"):
            tat.flash_bwd_dkv_cuda(*args, lse, lse, True)
    assert tat.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(s, s, c) for s in (1, 63, 65, 200, 1000)
                                          for c in (True, False)]
                         + [(100, 300, False), (300, 100, False)])
def test_flash_dq_tensor_core_kernel_matches_plain(cuda, d, sq, sk, causal):
    # the bfloat16 split dQ (K6a, flash_bwd_tc.cu's dQ pass): ragged query
    # and key tiles, a single query, sq != sk; dQ in registers, no atomics,
    # so two launches on the same inputs agree bit for bit
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    q, k, v, do = _attn_inputs(cuda, (3, sq, d), torch.bfloat16, seed=sq + 5 * sk + d, sk=sk)
    out_p, lse_p = tat.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, causal)
    before = dict(tat.launches)
    dq = tat.flash_bwd_dq_cuda(*args)
    again = tat.flash_bwd_dq_cuda(*args)
    want = tat.flash_bwd_split_plain(*args)[0]
    sc = tat.flash_error_scales(*args)["dq"]
    torch.cuda.synchronize()
    assert {n: tat.launches[n] - before[n] for n in before} == {
        "flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 2, "flash_bwd_dkv": 0}
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert bool(torch.isfinite(dq.float()).all())
    assert torch.equal(dq, again)
    _close(dq, want, torch.bfloat16, "K6a dq", sc)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_dq_tensor_core_kernel_one_key_heads(cuda, d):
    # a query that sees one key (every causal head's first): the exact dS is
    # 0 and dQ is only the rounding noise of dP - delta, which the kernel
    # must make the plain version's (dP recomputed in order of d)
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    q, k, v, do = _attn_inputs(cuda, (4096, 1, d), torch.bfloat16, seed=d)
    out_p, lse_p = tat.flash_fwd_plain(q, k, v, True)
    args = (q, k, v, do, lse_p, (do.float() * out_p.float()).sum(-1), True)
    dq = tat.flash_bwd_dq_cuda(*args)
    want = tat.flash_bwd_split_plain(*args)[0]
    _close(dq, want, torch.bfloat16, "K6a dq", tat.flash_error_scales(*args)["dq"])


@pytest.mark.gpu
def test_flash_dq_tensor_core_kernel_rejects_misaligned(cuda):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    bh, s, d = 2, 128, 64
    q = torch.randn(bh, s, d, device=cuda).to(torch.bfloat16)
    lse = torch.zeros(bh, s, device=cuda)
    odd = torch.empty(bh * s * d + 1, device=cuda, dtype=torch.bfloat16)[1:].view(bh, s, d)
    odd.copy_(q)
    before = dict(tat.launches)
    for i, name in enumerate(("q", "k", "v", "do")):
        args = [q, q, q, q]
        args[i] = odd
        with pytest.raises(ValueError, match=f"{name} must be 16-byte aligned"):
            tat.flash_bwd_dq_cuda(*args, lse, lse, True)
    assert tat.launches == before
    # float32 has no such requirement (the scalar kernel's element loads)
    odd32 = torch.empty(bh * s * d + 1, device=cuda)[1:].view(bh, s, d)
    odd32.copy_(q.float())
    got = tat.flash_bwd_dq_cuda(odd32, odd32, odd32, odd32, lse, lse, True)
    torch.cuda.synchronize()
    assert tat.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("bwd_impl,dtype", [("fused", torch.float32), ("split", torch.float32),
                                            ("fused", torch.bfloat16), ("split", torch.bfloat16)])
def test_flash_attention_autograd_on_the_card(cuda, bwd_impl, dtype):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    rng = np.random.default_rng(7)
    arrs = [rng.normal(size=(2, 3, 256, 64)).astype(np.float32) for _ in range(4)]
    before = dict(tat.launches)
    qc, kc, vc = (torch.from_numpy(a).to(cuda, dtype).requires_grad_(True) for a in arrs[:3])
    doc = torch.from_numpy(arrs[3]).to(cuda, dtype)
    tat.flash_attention(qc, kc, vc, causal=True, bwd_impl=bwd_impl).backward(doc)
    torch.cuda.synchronize()
    launched = {n: tat.launches[n] - before[n] for n in before}
    if bwd_impl == "fused":
        assert launched == {"flash_fwd": 1, "flash_bwd_fused": 1, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}
    else:
        assert launched == {"flash_fwd": 1, "flash_bwd_fused": 0, "flash_bwd_dq": 1,
                            "flash_bwd_dkv": 1}
    grads = (qc.grad, kc.grad, vc.grad)
    if dtype == torch.float32:
        qr, kr, vr = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
        out_r = tat.flash_attention(qr, kr, vr, causal=True, bwd_impl=bwd_impl)
        out_r.backward(torch.from_numpy(arrs[3]))
        for got, want in zip(grads, (qr.grad, kr.grad, vr.grad)):
            _close(got, want, torch.float32, "grad")
        return
    # bfloat16: the backward's inputs are K4's out and lse (deterministic), so
    # the same inputs through the plain backward give the reference (K6a's
    # dQ and K6b's dK/dV held as K5's are)
    flat = [t.detach().reshape(6, 256, 64) for t in (qc, kc, vc, doc)]
    out, lse2 = tat.flash_fwd_cuda(*flat[:3], True)
    delta = (flat[3].float() * out.float()).sum(-1)
    args = (*flat, lse2, delta, True)
    want = tat.flash_bwd_fused_plain(*args)
    sc = tat.flash_error_scales(*args)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == torch.bfloat16
        _close(got.reshape(6, 256, 64), w, torch.bfloat16, f"grad {name}", sc[name])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,exc", [(torch.float16, 64, TypeError),
                                         (torch.bfloat16, 8, ValueError),
                                         (torch.float32, 48, ValueError),
                                         (torch.bfloat16, 256, ValueError)])
@pytest.mark.parametrize("seq", [128, 100])
def test_flash_attention_rejects_what_the_kernel_cannot_take(cuda, dtype, d, exc, seq):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    q = torch.randn(1, 2, seq, d, device=cuda).to(dtype)
    before = dict(tat.launches)
    if seq % 128 == 0:
        with pytest.raises(exc):
            tat.flash_attention(q, q, q, causal=True)
    with pytest.raises(exc):
        tat.auto_attention(q, q, q)
    assert tat.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("seq", [64, 100, 1000])
def test_auto_attention_launches_the_kernels_at_any_length(cuda, seq):
    # no flash blocking divides these lengths: the CPU takes the blockwise
    # scan, the card still runs K4 and K5
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    rng = np.random.default_rng(seq)
    arrs = [rng.normal(size=(2, 3, seq, 64)).astype(np.float32) for _ in range(4)]
    before = dict(tat.launches)
    qc, kc, vc = (torch.from_numpy(a).to(cuda).requires_grad_(True) for a in arrs[:3])
    out = tat.auto_attention(qc, kc, vc)
    out.backward(torch.from_numpy(arrs[3]).to(cuda))
    torch.cuda.synchronize()
    assert {n: tat.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_fused": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    qr, kr, vr = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    out_r = tat.auto_attention(qr, kr, vr)
    out_r.backward(torch.from_numpy(arrs[3]))
    _close(out, out_r, torch.float32, "out")
    for got, want in ((qc.grad, qr.grad), (kc.grad, kr.grad), (vc.grad, vr.grad)):
        _close(got, want, torch.float32, "grad")
    with pytest.raises(ValueError, match="sq == sk"):
        tat.auto_attention(qc[:, :, :seq // 2], kc, vc)


@pytest.mark.gpu
def test_flash_kernel_rejects_non_contiguous(cuda):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    q = torch.randn(2, 64, 128, device=cuda).transpose(1, 2)  # (2, 128, 64), strided
    with pytest.raises(ValueError, match="contiguous"):
        tat.flash_fwd_cuda(q, q, q, True)


@pytest.mark.gpu
def test_lm_train_step_runs_the_flash_kernels(cuda):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat
    from distributed_ml_pytorch_tpu_torch.training import train_lm

    before = dict(tat.launches)
    # the default width: 8 heads of d_model 128, head_dim 16
    res = train_lm.run(train_lm.parse_args(
        ["--steps", "3", "--dtype", "bfloat16", "--pos-encoding", "rope", "--lr", "0.5"]))
    assert all(np.isfinite(res.losses)) and res.losses[-1] < res.losses[0]
    assert tat.launches["flash_fwd"] - before["flash_fwd"] == 2 * 3
    assert tat.launches["flash_bwd_fused"] - before["flash_bwd_fused"] == 2 * 3


@pytest.mark.gpu
def test_default_widths_run_on_the_card(cuda, capsys):
    # train_lm and the serving demo with no width flags (head_dim 16)
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.serving import cli as serving_cli
    from distributed_ml_pytorch_tpu_torch.training import train_lm

    before = dict(tat.launches)
    res = train_lm.run(train_lm.parse_args(["--steps", "2"]))
    assert all(np.isfinite(res.losses))
    assert tat.launches["flash_fwd"] - before["flash_fwd"] == 2 * 2
    assert tat.launches["flash_bwd_fused"] - before["flash_bwd_fused"] == 2 * 2
    before_k8 = da.launches
    assert serving_cli.main(["--demo", "4"]) == 0
    assert "serving demo complete" in capsys.readouterr().out
    assert da.launches > before_k8


@pytest.mark.gpu
@pytest.mark.parametrize("op,dtype,kernel,other", [
    ("K4", torch.float32, "flash_fwd_kernel", "flash_fwd_tc_kernel"),
    ("K4", torch.bfloat16, "flash_fwd_tc_kernel", "flash_fwd_kernel"),
    ("K5", torch.float32, "flash_bwd_kv_kernel", "flash_bwd_tc_kernel"),
    ("K5", torch.bfloat16, "flash_bwd_tc_kernel", "flash_bwd_kv_kernel"),
    ("K6b", torch.float32, "flash_bwd_kv_kernel", "flash_bwd_dkv_tc_kernel"),
    ("K6b", torch.bfloat16, "flash_bwd_dkv_tc_kernel", "flash_bwd_kv_kernel"),
    ("K6a", torch.float32, "flash_bwd_dq_kernel", "flash_bwd_dq_tc_kernel"),
    ("K6a", torch.bfloat16, "flash_bwd_dq_tc_kernel", "flash_bwd_dq_kernel")])
def test_kernel_breakdown_sees_the_card(cuda, op, dtype, kernel, other):
    # K4-K6b by kernel name: float32 keeps the scalar kernels (the
    # tensor cores have no float32 mode that keeps its numbers), bfloat16
    # takes the tensor cores
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    q = torch.randn(4, 512, 64, device=cuda).to(dtype)
    lse = torch.zeros(4, 512, device=cuda)
    fn = {"K4": lambda: tat.flash_fwd_cuda(q, q, q, True),
          "K5": lambda: tat.flash_bwd_fused_cuda(q, q, q, q, lse, lse, True),
          "K6b": lambda: tat.flash_bwd_dkv_cuda(q, q, q, q, lse, lse, True),
          "K6a": lambda: tat.flash_bwd_dq_cuda(q, q, q, q, lse, lse, True)}[op]
    res = kernel_breakdown(fn, {op: [kernel], f"other {op}": [other]})
    assert res["group_ms"][op] > 0 and res["group_ms"][f"other {op}"] == 0
    assert res["lost_launches"] == 0
    assert res["busy_ms"] <= res["wall_ms"]
    assert 0.0 <= res["idle_share"] < 1.0


# ------------------------------------------------------------------ decode attention (K8)

#: K8 against its reference on the same inputs, |kernel - reference| <= atol
#: + rtol * scale, the scale being ``decode_error_scale`` (P·|V| over the
#: three parts, P·scale_v·|V8| for an int8 cache). float32: the same sums in
#: other orders. bfloat16 (u = 2^-8): the reference rounds p (times scale_v)
#: to bfloat16 before its P·V products, at most u of each term, and each side
#: rounds its output: within 4u = 2^-6 of the absolute product.
DECODE_TOL = {torch.float32: dict(atol=2e-6, rtol=2e-5),
              torch.bfloat16: dict(atol=1e-6, rtol=2.0 ** -6)}


def _decode_inputs(cuda, b, h, C, T, d, dtype, quant, seed, t, ring_base, pad=0):
    """K8's inputs from numpy; the big cache is a live-prefix view of a
    ``C + pad`` allocation when ``pad`` > 0."""
    from distributed_ml_pytorch_tpu_torch.models.transformer import quantize_kv

    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    q, kn, vn = (mk(b, h, 1, d).to(dtype) for _ in range(3))
    rk, rv = (mk(b, h, T, d).to(dtype) for _ in range(2))
    bk, bv = mk(b, h, C + pad, d), mk(b, h, C + pad, d)
    sk = sv = None
    if quant:
        (bk, sk), (bv, sv) = quantize_kv(bk), quantize_kv(bv)
        sk, sv = sk[:, :, :C], sv[:, :, :C]
    else:
        bk, bv = bk.to(dtype), bv.to(dtype)
    bk, bv = bk[:, :, :C], bv[:, :, :C]
    tt = torch.as_tensor(t, dtype=torch.int32, device=cuda)
    rb = torch.as_tensor(ring_base, dtype=torch.int32, device=cuda)
    return q, kn, vn, bk, bv, rk, rv, tt, rb, sk, sv


def _decode_check(args, dtype):
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da

    before = da.launches
    got = da.decode_attention_step(*args)
    want = da.decode_attention_reference(*args)
    scale = da.decode_error_scale(*args)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
    tol = DECODE_TOL[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > tol["atol"] + tol["rtol"] * scale
    assert not bool(bad.any()), (float(err.max()), float((err / scale.clamp_min(1e-30)).max()))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype,quant", [(torch.float32, False), (torch.bfloat16, False),
                                         (torch.bfloat16, True), (torch.float32, True)])
@pytest.mark.parametrize("C", [1, 40, 383, 8192])
def test_decode_attention_kernel_matches_reference(cuda, d, dtype, quant, C):
    b, h, T = 3, 4, 16
    # per-row fill counts and live lengths: empty ring, partial, full; the
    # live prefix short, whole, and past C
    t = [0, 5, 16]
    ring_base = [0, C // 2, C + 7]
    args = _decode_inputs(cuda, b, h, C, T, d, dtype, quant, seed=d + C, t=t,
                          ring_base=ring_base, pad=9)
    _decode_check(args, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_kernel_scalar_state_and_strided_q(cuda, quant):
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da

    b, h, C, T, d = 4, 12, 256, 16, 64
    args = list(_decode_inputs(cuda, b, h, C, T, d, torch.bfloat16, quant, seed=3,
                               t=7, ring_base=200))
    # q / k_new / v_new as the model passes them: head-strided views of a
    # (b, 1, 3 * h * d) projection
    qkv = torch.randn(b, 1, 3 * h * d, device=cuda).to(torch.bfloat16)
    args[:3] = [qkv[..., i * h * d:(i + 1) * h * d].reshape(b, 1, h, d).transpose(1, 2)
                for i in range(3)]
    _decode_check(tuple(args), torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention_step(*(x[..., :48] if x is not None and x.dim() == 4 else x
                                   for x in args))


#: per-row fill counts and live lengths of the split tests: an empty ring
#: and a full one, rows with no live key (ring_base = 0) beside live rows,
#: a live prefix past C
_SPLIT_T = [0, 5, 16, 0, 3, 16, 7, 0]


def _split_ring_base(C):
    return [0, C // 2, C + 7, 0, 1, 64, C, 200]


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("b,h", [(3, 4), (8, 12)])
@pytest.mark.parametrize("d,dtype,quant", [(16, torch.bfloat16, False), (16, torch.bfloat16, True),
                                           (64, torch.bfloat16, False), (64, torch.bfloat16, True),
                                           (128, torch.bfloat16, True), (128, torch.float32, False)])
def test_decode_attention_kernel_at_every_split(cuda, splits, b, h, d, dtype, quant):
    # K8 with its keys split over a cluster of 1, 2, 4 or 8 blocks, forced,
    # against the reference and against one block per (b, h)
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da

    C, T = 383, 16
    args = _decode_inputs(cuda, b, h, C, T, d, dtype, quant, seed=b * h + d,
                          t=_SPLIT_T[:b], ring_base=_split_ring_base(C)[:b], pad=9)
    before = da.launches
    got = da.decode_attention_cuda(*args, splits=splits)
    one = da.decode_attention_cuda(*args, splits=1)
    want = da.decode_attention_reference(*args)
    scale = da.decode_error_scale(*args)
    torch.cuda.synchronize()
    assert da.launches == before + 2
    assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
    tol = DECODE_TOL[dtype]
    for ref in (want, one):
        err = (got.float() - ref.float()).abs()
        bad = err > tol["atol"] + tol["rtol"] * scale
        assert not bool(bad.any()), (float(err.max()),
                                     float((err / scale.clamp_min(1e-30)).max()))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_kernel_long_cache_eight_splits(cuda, quant):
    # batch-1-sized rows over a long cache: eight blocks per (b, h), each
    # with about a thousand keys, and a row with none
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da

    C, T = 8192, 16
    assert da.decode_splits(3 * 4, C, 132) == 8
    args = _decode_inputs(cuda, 3, 4, C, T, 64, torch.bfloat16, quant, seed=11,
                          t=[16, 0, 9], ring_base=[C, 0, 5000])
    got = da.decode_attention_cuda(*args, splits=8)
    one = da.decode_attention_cuda(*args, splits=1)
    want = da.decode_attention_reference(*args)
    scale = da.decode_error_scale(*args)
    torch.cuda.synchronize()
    tol = DECODE_TOL[torch.bfloat16]
    assert bool(torch.isfinite(got.float()).all())
    for ref in (want, one):
        err = (got.float() - ref.float()).abs()
        assert not bool((err > tol["atol"] + tol["rtol"] * scale).any()), float(err.max())


@pytest.mark.gpu
def test_decode_attention_kernel_rejects_other_split_counts(cuda):
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da

    args = _decode_inputs(cuda, 2, 2, 64, 16, 64, torch.bfloat16, False, seed=0, t=3,
                          ring_base=10)
    before = da.launches
    for splits in (0, 3, 16):
        with pytest.raises(ValueError, match="splits"):
            da.decode_attention_cuda(*args, splits=splits)
    assert da.launches == before


@pytest.mark.gpu
def test_generate_and_engine_on_the_card_launch_k8(cuda):
    from distributed_ml_pytorch_tpu_torch.models.generate import generate
    from distributed_ml_pytorch_tpu_torch.models.transformer import TransformerLM
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.serving.engine import ServingEngine

    calls = []
    real = da.decode_attention_reference
    da.decode_attention_reference = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        model = TransformerLM(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                              max_len=256, dtype=torch.bfloat16, device=cuda)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(0, 128, size=(2, 6)))
        before = da.launches
        out = generate(model, prompt, 2 * 16 + 1)
        torch.cuda.synchronize()
        assert out.shape == (2, 6 + 33) and int(out.max()) < 128
        assert da.launches - before == 2 * 2 * 16  # layers x padded steps
        q = generate(model, prompt, 2 * 16 + 1, kv_quant=True)
        assert q.shape == out.shape and int(q.max()) < 128 and int(q.min()) >= 0
        engine = ServingEngine(model, slots=2, cache_size=96, decode_block=8,
                               prefill_bucket=8)
        before = da.launches
        reqs = [engine.submit(prompt[i].numpy(), 20, temperature=0.8 * i, top_k=5, seed=i)
                for i in range(2)]
        engine.run_until_idle()
        assert all(r.done and len(r.tokens) == 20 for r in reqs)
        assert da.launches - before == 2 * 8 * 3  # layers x block steps x blocks
        assert not calls
    finally:
        da.decode_attention_reference = real


# ------------------------------------------------------------------ bias_relu (K3)

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1000, 37), (4096, 384), (256, 4, 4, 384), (3, 5, 8)])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_relu_kernels_bit_identical(cuda, shape, with_bias, dtype):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=shape[-1]).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    x[0, ..., 0] = -b[0]  # z = 0 exactly
    bias = b if with_bias else None
    bc = None if bias is None else bias.to(cuda)
    before = dict(tfc.launches)
    y = tfc.bias_relu_fwd_cuda(x.to(cuda), bc)
    dz = tfc.bias_relu_bwd_cuda(x.to(cuda), bc, g.to(cuda))
    # an odd offset: not 16-byte aligned, the scalar variant
    xo = torch.cat([torch.zeros(1, dtype=dtype), x.reshape(-1)]).to(cuda)[1:].view(shape)
    yo = tfc.bias_relu_fwd_cuda(xo, bc)
    torch.cuda.synchronize()
    assert tfc.launches["bias_relu_fwd"] == before["bias_relu_fwd"] + 2
    assert tfc.launches["bias_relu_bwd"] == before["bias_relu_bwd"] + 1
    want_y = tfc.bias_relu_fwd_plain(x, bias)
    want_dz = tfc.bias_relu_bwd_plain(x, bias, g)
    assert torch.equal(y.cpu(), want_y) and torch.equal(yo.cpu(), want_y)
    assert torch.equal(dz.cpu(), want_dz)


@pytest.mark.gpu
def test_bias_relu_autograd_on_the_card(cuda):
    rng = np.random.default_rng(5)
    arrs = [rng.normal(size=s).astype(np.float32) for s in ((64, 37), (37,), (64, 37))]
    xc, bc = (torch.from_numpy(a).to(cuda).requires_grad_(True) for a in arrs[:2])
    before = dict(tfc.launches)
    tfc.bias_relu(xc, bc).backward(torch.from_numpy(arrs[2]).to(cuda))
    xr, br = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:2])
    tfc.bias_relu(xr, br).backward(torch.from_numpy(arrs[2]))
    torch.cuda.synchronize()
    assert tfc.launches["bias_relu_fwd"] - before["bias_relu_fwd"] == 1
    assert tfc.launches["bias_relu_bwd"] - before["bias_relu_bwd"] == 1
    assert torch.equal(xc.grad.cpu(), xr.grad)
    np.testing.assert_allclose(bc.grad.cpu().numpy(), br.grad.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfc.bias_relu(torch.ones(4, 4, device=cuda, dtype=torch.float16))


# ------------------------------------------------------------------ fused head (K7)

#: K7 against head_update_plain on the same inputs, from W = 0 (the result
#: is -lr dW itself) and from the real W: |got - want| <= 2^-23 |W| + rtol *
#: lr * (|dl|^T |h|). 2^-23 |W| is each side's one float32 rounding of W -
#: lr dW. float32: the same products summed in
#: another order, at most (N - 1) u = 2^-14 of the absolute product at N =
#: 1000. bfloat16: each side rounds each dl term to bfloat16, and where its
#: exp differs in the last bits the roundings can land a step apart, 2u =
#: 2^-7 (u = 2^-8) of the term.
HEAD_RTOL = {torch.float32: 2.0 ** -12, torch.bfloat16: 2.0 ** -7}


def _head_case(cuda, n, d, v, dtype, seed):
    rng = np.random.default_rng(seed)
    W = torch.from_numpy((rng.normal(size=(v, d)) * 0.02).astype(np.float32)).to(cuda)
    h2 = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda, dtype)
    logits = h2 @ W.to(dtype).t()
    lse = torch.logsumexp(logits.float(), dim=-1)
    labels = torch.from_numpy(rng.integers(0, v, n)).to(cuda)
    gscale = torch.from_numpy(rng.uniform(0, 1e-3, n).astype(np.float32)).to(cuda)
    gscale[::7] = 0.0
    return W, h2, logits, lse, labels, gscale


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,v", [(1000, 64, 677), (2047, 256, 5000), (64, 40, 3),
                                   (1000, 768, 680), (1000, 1024, 680), (20, 768, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("from_zero", [False, True])
def test_head_update_kernel_matches_plain(cuda, n, d, v, dtype, from_zero):
    # bfloat16: V = 677 and V = 3 take element loads; V = 5000, 680 and 64 the
    # TMA route, with ragged N and V tiles, D 256 (one consumer warpgroup), 768
    # (three), 1024 (two passes over D) and N 20, less than one stage
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.ops import fused_head as tfh

    full_float32()
    lr = 0.5
    W, h2, logits, lse, labels, gscale = _head_case(cuda, n, d, v, dtype, seed=n + v)
    if from_zero:
        W = torch.zeros_like(W)
    want = tfh.head_update_plain(W, h2, logits, lse, labels, gscale, lr)
    Wk = W.clone()
    route = tfh.head_update_route(h2, logits)
    before, before_route = tfh.launches, tfh.route_launches[route]
    out = tfh.head_update_sgd(Wk, h2, logits, lse, labels, gscale, lr, use_kernel=True)
    torch.cuda.synchronize()
    assert out is Wk and tfh.launches == before + 1
    assert tfh.route_launches[route] == before_route + 1
    dl = tfh.head_dlogits(h2, logits, lse, labels, gscale)
    scale = lr * (dl.float().abs().t() @ h2.float().abs())
    err = (Wk - want).abs()
    bound = 2.0 ** -23 * W.abs() + HEAD_RTOL[dtype] * scale
    assert bool((err <= bound).all()), (float(err.max()), float((err / bound).max()))
    assert not torch.equal(Wk, W)


@pytest.mark.gpu
def test_head_update_routes_count_and_repeat_bit_for_bit(cuda):
    # each input goes to the route the rule names and counts there alone;
    # two launches of a route from the same W give the same bits (no atomics)
    from distributed_ml_pytorch_tpu_torch.ops import fused_head as tfh

    W, h2, logits, lse, labels, gscale = _head_case(cuda, 1000, 768, 680, torch.bfloat16, 5)
    # the same values one element past a 16-byte boundary
    h2_off = torch.empty(h2.numel() + 1, dtype=h2.dtype, device=cuda)[1:].view_as(h2)
    h2_off.copy_(h2)
    cases = [("bf16_tma", (W, h2, logits, lse, labels, gscale)),
             ("bf16", (W, h2_off, logits, lse, labels, gscale)),
             ("f32", _head_case(cuda, 1000, 768, 680, torch.float32, 5))]
    for route, (w0, hh, *rest) in cases:
        assert tfh.head_update_route(hh, rest[0]) == route
        got = []
        for _ in range(2):
            before = dict(tfh.route_launches)
            wk = w0.clone()
            tfh.head_update_cuda(wk, hh, *rest, -0.5)
            torch.cuda.synchronize()
            after = dict(tfh.route_launches)
            assert after == {k: before[k] + (k == route) for k in before}, (route, after)
            got.append(wk)
        assert torch.equal(got[0], got[1]), route
        assert not torch.equal(got[0], w0)


@pytest.mark.gpu
def test_head_update_kernel_rejects_what_it_cannot_take(cuda):
    from distributed_ml_pytorch_tpu_torch.ops import fused_head as tfh

    W, h2, logits, lse, labels, gscale = _head_case(cuda, 64, 32, 50, torch.bfloat16, 0)
    before = tfh.launches
    with pytest.raises(TypeError, match="int64"):
        tfh.head_update_cuda(W, h2, logits, lse, labels.int(), gscale, -0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tfh.head_update_cuda(W, h2, logits.t().contiguous().t(), lse, labels, gscale, -0.1)
    with pytest.raises(TypeError, match="share"):
        tfh.head_update_cuda(W, h2, logits.float(), lse, labels, gscale, -0.1)
    # a float32 vocabulary past the float32 kernel's grid (64 columns a block)
    v = 64 * 65535 + 1
    args = (torch.zeros((v, 1), device=cuda), torch.zeros((1, 1), device=cuda),
            torch.zeros((1, v), device=cuda), torch.zeros(1, device=cuda),
            torch.zeros(1, dtype=torch.int64, device=cuda), torch.ones(1, device=cuda))
    with pytest.raises(ValueError, match="grid"):
        tfh.head_update_cuda(*args, -0.1)
    assert tfh.launches == before


@pytest.mark.gpu
def test_fused_head_step_launches_k7_once_per_step(cuda):
    from distributed_ml_pytorch_tpu_torch.models.transformer import TransformerLM
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat
    from distributed_ml_pytorch_tpu_torch.ops import fused_head as tfh
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import create_lm_train_state
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, 300, size=(2, 128))).to(cuda)
    runs = {}
    for use_kernel in (False, True):
        model = TransformerLM(vocab_size=300, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                              dtype=torch.bfloat16, pos_encoding="rope", seed=3, device=cuda)
        w0 = [p.detach().clone() for p in model.parameters()]
        step = tfh.make_fused_head_sgd_step(model, 0.5, use_kernel=use_kernel)
        state = create_lm_train_state(model, SGD(0.5))
        before, before_k4 = tfh.launches, tat.launches["flash_fwd"]
        losses = []
        for _ in range(2):
            state, loss = step(state, tok, tok)
            losses.append(float(loss))
        torch.cuda.synchronize()
        assert tfh.launches - before == (2 if use_kernel else 0)
        assert tat.launches["flash_fwd"] - before_k4 == 2 * 2
        runs[use_kernel] = (losses, [p.detach() - w for p, w in zip(model.parameters(), w0)])
    # the first step's forward is the same code on the same weights
    assert runs[True][0][0] == runs[False][0][0]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(runs[True][1], runs[False][1]))
    den = sum(float((b ** 2).sum()) for b in runs[False][1])
    assert (num / den) ** 0.5 <= 1e-2


@pytest.mark.gpu
def test_device_time_on_the_card(cuda):
    from distributed_ml_pytorch_tpu_torch.utils.devtime import device_time

    x = torch.randn(2048, 2048, device=cuda)
    t = device_time(lambda: x @ x, calls=5, warmup=2)
    assert t.source == "cuda_events" and t.calls == 5
    # 2 * 2048^3 FLOP in full float32 cannot beat 67 TFLOP/s by much
    assert 2 * 2048 ** 3 / t.per_call_s < 2 * 67e12


# ------------------------------------------------------------------ K2 in bfloat16

@pytest.mark.gpu
@pytest.mark.parametrize("shape,misaligned,route", [
    ((1024, 8, 8, 64), False, "vector"), ((1024, 4, 4, 192), False, "vector"),
    ((1024, 2, 2, 256), False, "vector"), ((64, 8, 8, 64), False, "vector"),
    ((64, 4, 4, 37), False, "scalar"), ((64, 4, 4, 36), False, "scalar"),
    ((64, 8, 8, 64), True, "scalar")])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_relu_pool2_bf16_routes_bit_identical(cuda, shape, misaligned, route, with_bias, ties):
    """bfloat16, bit-identical forward and backward: the batch-1024 tails on
    the 8-channel vector route; C % 8 != 0 and a view one element (2 bytes)
    into its storage on the scalar route."""
    x, b, g = _pool_inputs(shape, seed=3, ties=ties)
    bf = torch.bfloat16
    xr, br, gr = (torch.from_numpy(a).to(bf) for a in (x, b, g))
    if misaligned:
        xc = torch.empty(xr.numel() + 1, device=cuda, dtype=bf)[1:].view(shape)
        xc.copy_(xr.to(cuda))
        assert xc.is_contiguous() and xc.data_ptr() % 16 == 2
    else:
        xc = xr.to(cuda)
    bc = br.to(cuda) if with_bias else None
    before = dict(tfc.launches)
    m = tfc.relu_pool2_fwd_cuda(xc, bc)
    dx = tfc.relu_pool2_bwd_cuda(xc, bc, m, gr.to(cuda))
    torch.cuda.synchronize()
    ran = {k: tfc.launches[k] - before[k] for k in before if k.startswith("relu_pool2")}
    for d in ("fwd", "bwd"):
        assert ran[f"relu_pool2_{d}.bf16.{route}"] == ran[f"relu_pool2_{d}"] == 1
        assert ran[f"relu_pool2_{d}.vector"] == ran[f"relu_pool2_{d}.scalar"] == 0
    mr = tfc.relu_pool2_fwd_plain(xr, br if with_bias else None)
    dr = tfc.relu_pool2_bwd_plain(xr, br if with_bias else None, mr, gr)
    assert m.dtype == dx.dtype == bf
    assert torch.equal(m.cpu(), mr) and torch.equal(dx.cpu(), dr)
    # and the plain versions on the card agree with them on the CPU
    assert torch.equal(tfc.relu_pool2_fwd_plain(xc, bc).cpu(), mr)


@pytest.mark.gpu
def test_relu_pool2_refuses_mixed_dtypes_on_the_card(cuda):
    x = torch.randn(2, 4, 4, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bias"):
        tfc.relu_pool2_fwd_cuda(x, torch.zeros(8, device=cuda))
    with pytest.raises(TypeError, match="bfloat16"):
        tfc.relu_pool2_fwd_cuda(x.half())
    m = tfc.relu_pool2_fwd_cuda(x)
    with pytest.raises(ValueError, match="g must be"):
        tfc.relu_pool2_bwd_cuda(x, None, m, m.float())


# ------------------------------------------------------------------ graphed trainer

def _deterministic():
    from distributed_ml_pytorch_tpu_torch.device import full_float32

    full_float32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _k_batches(k, b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, size=(k, b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=(k, b)).astype(np.int64))


def _flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", [("alexnet", torch.float32), ("alexnet", torch.bfloat16),
                                        ("lenet", torch.float32)])
def test_graphed_k_steps_equal_eager_steps(cuda, name, dtype):
    """Two dispatches of 6 (2 eager warm-up steps, a capture, replays) equal
    12 eager steps bit for bit: the schedule's lr, Adam's bias correction
    and the clipping read device tensors, and LeNet's dropout generator is
    registered with the graph, so replays draw fresh masks."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr

    _deterministic()
    x, y = _k_batches(12, 16)
    runs = []
    for graphed in (True, False):
        model = get_model(name, fused_epilogue=True, seed=1, device=cuda, dtype=dtype)
        tx = ttr.build_tx("adamw", ttr.make_lr_schedule("cosine", 1e-3, 4, 3), grad_clip=1.0)
        state = ttr.create_train_state(model, tx,
                                       torch.Generator(device=cuda).manual_seed(7))
        if graphed:
            scan = ttr.make_scan_train_step(model, tx)
            losses = torch.cat([scan(state, x[i:i + 6], y[i:i + 6])[1] for i in (0, 6)])
            assert scan.graphed.captures == 1
        else:
            step = ttr.make_train_step(model, tx)
            losses = torch.stack([step(state, x[i], y[i])[1].float() for i in range(12)])
        runs.append((losses.cpu(), _flat_params(model).cpu(), int(state.opt_state.count),
                     state.generator.get_state()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2] == 12
    assert torch.equal(runs[0][3], runs[1][3])


@pytest.mark.gpu
def test_graph_is_rebuilt_when_the_batch_shape_changes(cuda):
    """A shorter dispatch of the same shape replays the graph; a new batch
    shape rebuilds it (warm-up, capture), never replays over it: the losses
    and parameters equal the same steps run eagerly."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr

    _deterministic()
    x, y = _k_batches(4, 16)
    xs, ys = _k_batches(4, 8, seed=1)
    dispatches = [(x, y), (x[:3], y[:3]), (xs, ys)]
    runs = []
    for graphed in (True, False):
        model = get_model("alexnet", fused_epilogue=True, device=cuda)
        tx = ttr.build_tx("sgd", 0.01)
        state = ttr.create_train_state(model, tx)
        scan, step = ttr.make_scan_train_step(model, tx), ttr.make_train_step(model, tx)
        losses, captures = [], []
        for bx, by in dispatches:
            if graphed:
                losses.append(scan(state, bx, by)[1])
                captures.append(scan.graphed.captures)
            else:
                losses += [step(state, bx[i], by[i])[1].reshape(1) for i in range(len(bx))]
        runs.append((torch.cat(losses).cpu(), _flat_params(model).cpu(), captures, state.step))
    assert runs[0][2] == [1, 1, 2] and runs[0][3] == runs[1][3] == 11
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.gpu
def test_graphed_accumulation_equals_eager_updates(cuda):
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr

    _deterministic()
    x, y = _k_batches(5, 32, seed=1)
    runs = []
    for graphed in (True, False):
        model = get_model("alexnet", fused_epilogue=True, seed=2, device=cuda)
        tx = ttr.build_tx("sgd", 0.008, momentum=0.9)
        state = ttr.create_train_state(model, tx)
        if graphed:
            scan = ttr.make_scan_accum_train_step(model, tx, 8, effective_update_batch=4)
            losses = scan(state, x, y)[1]
        else:
            step = ttr.make_accum_train_step(model, tx, 8, effective_update_batch=4)
            losses = torch.stack([step(state, x[i], y[i])[1] for i in range(5)])
        runs.append((losses.cpu(), _flat_params(model).cpu()))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.gpu
def test_resume_on_the_card_equals_an_uninterrupted_run(cuda, tmp_path, monkeypatch):
    from distributed_ml_pytorch_tpu_torch.training import cli
    from distributed_ml_pytorch_tpu_torch.utils import checkpoint as tck

    _deterministic()

    class Stop(Exception):
        pass

    def argv(tag):
        return ["--no-distributed", "--model", "alexnet", "--dtype", "bfloat16", "--epochs", "2",
                "--synthetic-data", "--synthetic-train-size", "192", "--synthetic-test-size",
                "32", "--batch-size", "16", "--log-interval", "5", "--optimizer", "adamw",
                "--lr-schedule", "cosine", "--grad-clip", "1.0", "--grad-accum", "2",
                "--steps-per-dispatch", "4", "--ckpt-every", "6", "--ckpt-dir",
                str(tmp_path / tag / "ck"), "--log-dir", str(tmp_path / tag)]

    assert cli.main(argv("full")) == 0
    real_save = tck.Checkpointer.save

    def save_then_stop(self, step, state, *, force=False):
        accepted = real_save(self, step, state, force=force)
        if accepted and not force and step == 12:
            raise Stop
        return accepted

    monkeypatch.setattr(tck.Checkpointer, "save", save_then_stop)
    with pytest.raises(Stop):
        cli.main(argv("cut"))
    monkeypatch.setattr(tck.Checkpointer, "save", real_save)
    assert cli.main([*argv("cut"), "--resume"]) == 0
    a = torch.load(tmp_path / "full" / "ck" / "24" / "state.pt", weights_only=True)
    b = torch.load(tmp_path / "cut" / "ck" / "24" / "state.pt", weights_only=True)
    assert a["step"] == b["step"] == 24
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert torch.equal(a["generator"], b["generator"])

    def losses(tag):
        import csv

        with open(tmp_path / tag / "gpu.csv", newline="") as fh:
            return [(r["iteration"], r["training_loss"], r["test_loss"])
                    for r in csv.DictReader(fh)]

    assert losses("cut") == losses("full")[12:]


@pytest.mark.gpu
def test_prefetch_on_the_card_hands_over_the_batches_unchanged(cuda):
    from distributed_ml_pytorch_tpu_torch.data import iterate_batches, prefetch_to_device

    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 32, 32, 3)).astype(np.float32)
    y = (np.arange(40) % 10).astype(np.int32)
    plain = list(iterate_batches(x, y, 8, seed=1))
    got = list(prefetch_to_device(iterate_batches(x, y, 8, seed=1), 3, cuda))
    assert len(got) == len(plain)
    for (a, b), (c, d) in zip(got, plain):
        assert a.is_cuda and a.dtype == torch.float32 and b.dtype == torch.int64
        assert torch.equal(a.cpu(), torch.from_numpy(c))
        assert torch.equal(b.cpu(), torch.from_numpy(d.astype(np.int64)))


@pytest.mark.gpu
def test_per_step_training_with_prefetch_equals_without(cuda, tmp_path):
    """The per-step path on the card (LeNet, dropout from the state's
    generator): batches prefetched on a side stream train the same
    parameters as batches copied in the step."""
    from distributed_ml_pytorch_tpu_torch.training import cli
    from distributed_ml_pytorch_tpu_torch.training.trainer import train_single

    _deterministic()
    flats = []
    for n in (0, 2):
        args = cli.build_parser().parse_args([
            "--no-distributed", "--model", "lenet", "--epochs", "1", "--synthetic-data",
            "--synthetic-train-size", "256", "--synthetic-test-size", "32", "--batch-size",
            "16", "--log-interval", "8", "--optimizer", "adam", "--lr", "0.003",
            "--prefetch", str(n), "--log-dir", str(tmp_path / str(n))])
        state, logger = train_single(args, device=cuda)
        flats.append((_flat_params(state.model).cpu(),
                      [r["training_loss"] for r in logger.records]))
    assert torch.equal(flats[0][0], flats[1][0]) and flats[0][1] == flats[1][1]


def _downpour_worker(cuda, seed=3):
    """A DownPour worker (AlexNet fused) against a world nobody serves, its
    sends recorded by kind."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    model = get_model("alexnet", fused_epilogue=True, seed=seed, device=cuda)
    opt = tps.Asynchronous(model, lr=0.008, n_push=10, n_pull=10,
                           transport=InProcessTransport.create_world(2)[1])
    pushes = []
    opt._send = lambda code, payload: (int(code) == 2 and pushes.append(
        np.array(payload, np.float32)))
    return model, opt, pushes


def _drive(opt, model, x, y, chunked, gen=None):
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads

    n = len(x)
    if chunked:
        chunk = tps._chunk_step_cache(opt, 64)
        for gap, length in tps.downpour_chunk_schedule(opt.n_push, opt.n_pull, 0, n):
            opt.boundary(gap)
            chunk(opt.opt_state, x[gap:gap + length], y[gap:gap + length], gen)
            opt.idx = gap + length
    else:
        dev = next(model.parameters()).device
        for i in range(n):
            loss_and_grads(model, torch.from_numpy(x[i]).to(dev),
                           torch.from_numpy(y[i]).to(dev), generator=gen)
            opt.step()
    opt.finish()
    return _flat_params(model).cpu()


@pytest.mark.gpu
def test_chunked_downpour_worker_equals_per_step_on_the_card(cuda):
    """30 DownPour steps (n_push = n_pull = 10: runs of 1 and 9 steps) as
    chunks, one captured step replayed, against 30 eager per-step steps from
    the same weights: every push and the final parameters bit for bit, and
    one capture for both run lengths."""
    _deterministic()
    x, y = _k_batches(30, 16, seed=4)
    runs = []
    for chunked in (True, False):
        model, opt, pushes = _downpour_worker(cuda)
        runs.append((_drive(opt, model, x, y, chunked), pushes, opt))
    (pa, sa, chunked_opt), (pb, sb, _) = runs
    assert chunked_opt._chunk_step.graphed.captures == 1
    assert torch.equal(pa, pb) and len(sa) == len(sb) == 4
    for a, b in zip(sa, sb):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_two_workers_capture_and_replay_in_threads(cuda):
    """Two chunked workers as threads of one process, each capturing its
    step while the other trains (the capture is thread-local and one at a
    time): both finish, and each equals the same worker run alone, eagerly,
    bit for bit."""
    import threading

    _deterministic()
    data = {r: _k_batches(40, 16, seed=r) for r in (1, 2)}
    alone = {}
    for r in (1, 2):
        model, opt, pushes = _downpour_worker(cuda, seed=r)
        alone[r] = (_drive(opt, model, *data[r], chunked=False), pushes)
    together, errors = {}, []

    def run(r):
        try:
            model, opt, pushes = _downpour_worker(cuda, seed=r)
            together[r] = (_drive(opt, model, *data[r], chunked=True), pushes,
                           opt._chunk_step.graphed.captures)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads), errors
    for r in (1, 2):
        params, pushes, captures = together[r]
        assert captures == 1 and torch.equal(params, alone[r][0])
        for a, b in zip(pushes, alone[r][1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_a_failed_capture_raises_and_nothing_falls_back(cuda, monkeypatch):
    """A capture that fails raises out of the chunk step (and so out of
    ``train_worker``), after the two eager warm-up steps: the graph is not
    replaced by eager steps."""
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr

    _deterministic()
    x, y = _k_batches(10, 16, seed=5)

    def refuse(self, *a, **k):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(ttr.GraphedSteps, "_capture", refuse)
    model, opt, pushes = _downpour_worker(cuda)
    with pytest.raises(RuntimeError, match="capture refused"):
        _drive(opt, model, x, y, chunked=True)
    assert opt._chunk_step.graphed.captures == 0 and opt._chunk_step.graphed.graph is None
    opt._flusher.stop()
    opt.listener.stop()


@pytest.mark.gpu
def test_native_library_loads_on_the_card_machine(cuda):
    """The native transport builds with this machine's g++ from the port's
    own source and carries a frame between two of its endpoints."""
    import socket
    import threading

    from distributed_ml_pytorch_tpu_torch import native
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

    assert native.native_available(), native.native_load_error()
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    out = {}
    th = threading.Thread(target=lambda: out.setdefault(
        "s", native.NativeTCPTransport(0, 2, "localhost", port)))
    th.start()
    w = native.NativeTCPTransport(1, 2, "localhost", port)
    th.join(timeout=30)
    try:
        w.send(MessageCode.GradientUpdate, np.arange(7, dtype=np.float32))
        msg = out["s"].recv(timeout=10)
        np.testing.assert_array_equal(msg[2], np.arange(7, dtype=np.float32))
    finally:
        w.close()
        out["s"].close()


@pytest.mark.gpu
def test_two_worker_processes_capture_beside_the_reliable_threads(cuda, tmp_path,
                                                                  monkeypatch):
    """A server and two chunked AlexNet worker processes on the card over
    the native transport with ``--reliable --wal``: each worker captures its
    step while its listener, heartbeat, flusher and retry threads run, and
    the world ends with every exit code 0 and every push applied once."""
    import json
    import os

    from distributed_ml_pytorch_tpu_torch.launch import launch_world

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PYTHONPATH", root)
    rc = launch_world(3, ["--epochs", "1", "--synthetic-data", "--synthetic-train-size",
                          str(20 * 64), "--synthetic-test-size", "64", "--test-batch-size",
                          "64", "--log-interval", "100000", "--worker-timeout", "0",
                          "--chunked-dispatch", "on", "--transport", "native", "--reliable",
                          "--wal", "--ckpt-dir", str(tmp_path / "ps"), "--log-dir",
                          str(tmp_path)])
    assert rc == 0
    for rank in (1, 2):
        with open(tmp_path / f"node{rank}.csv") as f:
            assert len(f.read().splitlines()) == 1 + 20
    with open(tmp_path / "ps" / "ps_meta.json") as f:
        meta = json.load(f)
    # pushes at steps 0 and 10 and the final one, from each worker
    assert meta["apply_seq"] == 6 and len(meta["recent_envelopes"]) == 6


def _pumped_downpour(cuda, k, x, y, n_push=10, n_pull=10):
    """An AlexNet-fused DownPour worker on the card over in-process
    transports against ``k`` shard servers (``k = 0``: the unsharded
    ``Asynchronous`` and one ``ParameterServer``), the listeners stopped
    and every mailbox pumped after each step, so installs land at fixed
    steps. Returns the pushes the servers took (the shards' slices
    joined), the final parameters and the worker's K1 launches."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import (
        ShardedAsynchronous,
        make_shard_server,
    )
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        InProcessTransport,
        MessageCode,
    )

    model = get_model("alexnet", fused_epilogue=True, seed=3, device=cuda)
    n = sum(p.numel() for p in model.parameters())
    worlds = [InProcessTransport.create_world(2) for _ in range(max(k, 1))]
    pushes = [[] for _ in worlds]
    handles = []
    for s, w in enumerate(worlds):
        srv = (tps.ParameterServer(params=np.zeros(n, np.float32), transport=w[0]) if k == 0
               else make_shard_server(params=np.zeros(n, np.float32), shard=s, n_shards=k,
                                      transport=w[0]))

        def handle(sender, code, payload, srv=srv, s=s):
            if code == MessageCode.GradientUpdate:
                pushes[s].append(np.array(payload, np.float32))
            srv.handle(sender, code, payload)

        handles.append(handle)
    if k == 0:
        opt = tps.Asynchronous(model, lr=0.008, n_push=n_push, n_pull=n_pull,
                               transport=worlds[0][1])
        listeners = [opt.listener]
    else:
        opt = ShardedAsynchronous(model, lr=0.008, n_push=n_push, n_pull=n_pull,
                                  transports=[w[1] for w in worlds])
        listeners = opt.listeners
    for listener in listeners:
        listener.stop()
        listener.join(timeout=5)
    before = tfu.launches
    for i in range(len(x)):
        loss_and_grads(model, torch.from_numpy(x[i]).to(cuda), torch.from_numpy(y[i]).to(cuda))
        opt.step()
        opt._flusher.drain()
        for w, handle, listener in zip(worlds, handles, listeners):
            while (m := w[0].recv(timeout=0.01)) is not None:
                handle(*m)
            while (m := w[1].recv(timeout=0.01)) is not None:
                listener.receive(*m)
    launched = tfu.launches - before
    opt._flusher.stop()
    return [np.concatenate(parts) for parts in zip(*pushes)], _flat_params(model).cpu(), launched


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
def test_sharded_client_equals_the_per_step_client_on_the_card(cuda, k):
    """25 DownPour steps on the card (n_push = n_pull = 10): the sharded
    client with one shard and with two equals the per-step ``Asynchronous``
    bit for bit, every push (slices joined) and the final parameters, with
    K1 launched once a step by both."""
    _deterministic()
    x, y = _k_batches(25, 16, seed=5)
    ref_pushes, ref_flat, ref_k1 = _pumped_downpour(cuda, 0, x, y)
    pushes, flat, k1 = _pumped_downpour(cuda, k, x, y)
    assert k1 == ref_k1 == 25
    assert len(pushes) == len(ref_pushes) == 3  # steps 0, 10, 20
    for a, b in zip(pushes, ref_pushes):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(flat, ref_flat)


@pytest.mark.gpu
def test_compressed_chunked_worker_frames_the_dense_pushes_through_its_encoder(cuda):
    """30 chunked DownPour steps on the card (AlexNet fused, n_push = n_pull
    = 10) with ``compress="int8"``: every CompressedUpdate frame equals, bit
    for bit, the frame a host encoder makes of the dense worker's push from
    the same weights on the same batches (K1 and K2 replayed in the graph
    either way), and the decoded pushes sum to the dense ones less the final
    residual."""
    from distributed_ml_pytorch_tpu_torch.utils.compress import (
        CompressingEncoder,
        decode_update,
        make_codec,
    )

    _deterministic()
    x, y = _k_batches(30, 16, seed=6)
    model, opt, dense = _downpour_worker(cuda)
    dense_flat = _drive(opt, model, x, y, True)
    model, opt, _ = _downpour_worker(cuda)
    opt.encoder = CompressingEncoder(opt._flat_n, make_codec("int8"))
    frames = []
    opt._sendv = lambda code, parts: frames.append(np.concatenate(parts))
    flat = _drive(opt, model, x, y, True)
    assert torch.equal(flat, dense_flat) and len(frames) == len(dense) == 4
    ref = CompressingEncoder(opt._flat_n, make_codec("int8"))
    total = np.zeros(opt._flat_n, np.float64)
    for frame, push in zip(frames, dense):
        np.testing.assert_array_equal(frame, np.concatenate(ref.encode_range(push, 0, push.size)))
        assert frame.size == 620_667
        total += decode_update(frame)[2]
    np.testing.assert_allclose(total, np.sum(dense, axis=0, dtype=np.float64) - ref.residual,
                               atol=1e-5)
    assert opt.encoder.residual_resets == 0


@pytest.mark.gpu
def test_compressed_sharded_client_frames_each_shard_on_the_card(cuda):
    """The sharded client on the card with top-k pushes and two shards:
    each push sends one unstamped frame a shard, of k = round(1 % of the
    shard's length) pairs, and the per-step path launches K1 once a step."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import ShardedAsynchronous
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
    from distributed_ml_pytorch_tpu_torch.utils.compress import unpack_frame
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    _deterministic()
    x, y = _k_batches(12, 16, seed=7)
    model = get_model("alexnet", fused_epilogue=True, seed=3, device=cuda)
    worlds = [InProcessTransport.create_world(2) for _ in range(2)]
    opt = ShardedAsynchronous(model, lr=0.008, n_push=10, n_pull=10,
                              transports=[w[1] for w in worlds], compress="topk")
    sent = []
    opt._sendv = lambda shard, code, parts: sent.append((shard, np.concatenate(parts)))
    before = tfu.launches
    for i in range(12):
        loss_and_grads(model, torch.from_numpy(x[i]).to(cuda), torch.from_numpy(y[i]).to(cuda))
        opt.step()
    opt._flusher.drain()
    assert tfu.launches - before == 12
    assert [s for s, _ in sent] == [0, 1, 0, 1]  # steps 0 and 10
    for shard, frame in sent:
        lo, hi = opt.ranges[shard]
        _cid, n, param, stamp, body = unpack_frame(frame)
        assert (n, param, stamp) == (hi - lo, 12_361, None) and body.size == 2 * 12_361
    opt.finish()


# ------------------------------------------------------------------ the LM trainer's flags

#: train_lm at a small width whose heads the tensor-core kernels take (2 x
#: 64), bfloat16, remat and the chunked loss: torch.utils.checkpoint inside
#: the captured step
LM_ARGV = ["--vocab", "512", "--d-model", "128", "--n-heads", "2", "--n-layers", "2",
           "--d-ff", "256", "--dtype", "bfloat16", "--pos-encoding", "rope", "--batch", "2",
           "--seq", "256", "--remat", "--loss-chunk", "128", "--steps-per-dispatch", "4",
           "--device", "cuda"]


def _split_attention():
    import functools

    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    # the split pair has no atomics: its steps repeat bit for bit
    return functools.partial(tat.flash_attention, causal=True, bwd_impl="split")


@pytest.mark.gpu
def test_lm_k_steps_graphed_equal_eager_steps_with_the_split_backward(cuda):
    """``train_lm --steps-per-dispatch 4 --steps 8`` (two dispatches of one
    captured step: 2 eager warm-up steps, the capture, replays) equals eight
    eager AD steps on the same batches in the same order, losses and
    parameters bit for bit, with one capture."""
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import create_lm_train_state
    from distributed_ml_pytorch_tpu_torch.training import train_lm
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    args = train_lm.parse_args([*LM_ARGV, "--steps", "8"])
    res = train_lm.run(args, attn_fn=_split_attention())
    assert res.step_fn.graphed.captures == 1 and res.state.step == 8
    model = train_lm.build_model(args, cuda)
    model.set_attn_fn(_split_attention())
    state = create_lm_train_state(model, SGD(args.lr))
    step = make_fsdp_lm_train_step(model, SGD(args.lr), loss_chunk=args.loss_chunk)
    tokens, targets = train_lm.lm_batches(args)
    tok, tgt = (torch.from_numpy(a.astype(np.int64)).to(cuda) for a in (tokens, targets))
    eager = [float(step(state, tok[i % 4], tgt[i % 4])[1]) for i in range(8)]
    assert res.losses == eager
    for a, b in zip(res.state.model.parameters(), model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_lm_resume_on_the_card_equals_an_uninterrupted_run(cuda, tmp_path):
    """Eight steps checkpointed every four, against four steps, then a
    resume that trains four more: the resumed run's losses and parameters
    equal the uninterrupted run's, bit for bit (the split backward)."""
    from distributed_ml_pytorch_tpu_torch.training import train_lm

    full = train_lm.run(train_lm.parse_args(
        [*LM_ARGV, "--steps", "8", "--ckpt-dir", str(tmp_path / "full"), "--ckpt-every", "4"]),
        attn_fn=_split_attention())
    assert sorted(os.listdir(tmp_path / "full")) == ["4", "8"]
    cut = [*LM_ARGV, "--steps", "4", "--ckpt-dir", str(tmp_path / "cut"), "--ckpt-every", "4"]
    train_lm.run(train_lm.parse_args(cut), attn_fn=_split_attention())
    resumed = train_lm.run(train_lm.parse_args([*cut, "--resume"]), attn_fn=_split_attention())
    assert resumed.start_step == 4 and resumed.state.step == 8
    assert resumed.losses == full.losses[4:]
    for a, b in zip(resumed.state.model.parameters(), full.state.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_split_kernels_at_32k_tokens_match_the_chunked_plain_version(cuda):
    """K6a and K6b at (3, 12, 32768, 64) bfloat16 causal, the smallest batch
    at which the size rule picks them at this length, on K4's lse and the
    delta of its output: every query and key of the last (b, h) against
    ``flash_plain_rows`` (2048 query rows at a time), within ATTN_TOL of
    each output's absolute product."""
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    b, h, s, d = 3, 12, 32768, 64
    q4 = torch.empty((b, h, s, d), device=cuda)
    assert tat._resolve_flash_config(q4, q4, True, None, None, None, None, None)[2] == "split"
    del q4
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn((b * h, s, d), generator=g, device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    out, lse2 = tat.flash_fwd_cuda(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse2, delta, True)
    dq = tat.flash_bwd_dq_cuda(*args)
    dk, dv = tat.flash_bwd_dkv_cuda(*args)
    last = b * h - 1
    ref = tat.flash_plain_rows(*(t[last:] for t in (q, k, v, do, lse2, delta)), True)
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        _close(got[last:], ref[name], torch.bfloat16, name, ref["scales"][name])


class _MapFeed:
    """Just enough of a ``CoordClient`` for an elastic worker driven by
    hand: it hands out the maps put in it and keeps the reports."""

    def __init__(self):
        self.maps, self.reports = [], []

    def take_shard_map(self):
        return self.maps.pop(0) if self.maps else None

    def report(self, *a, **k):
        self.reports.append(a)

    def report_gray_health(self, **k):
        pass


@pytest.mark.gpu
def test_elastic_cutover_on_the_card_runs_k1_and_k2_every_step(cuda):
    """An elastic AlexNet worker on the card against two elastic shard
    servers in one process: 10 steps under map v1 (two shards), a cutover
    to v2 (server 2 gone, server 1 owning the whole vector), 10 more steps.
    K1 runs once a step and K2 three times a step each way, on the vector
    route, across the cutover; the worker installs the fresh half of v2
    from its own parameters; every later push is stamped with v2's range
    and applied."""
    from distributed_ml_pytorch_tpu_torch.coord.elastic import ElasticShardServer
    from distributed_ml_pytorch_tpu_torch.coord.shardmap import ShardMap, rebalance
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import ShardedAsynchronous
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        InProcessTransport,
        MessageCode,
    )
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    _deterministic()
    model = get_model("alexnet", fused_epilogue=True, seed=3, device=cuda)
    flat0 = ravel_model_params(model).cpu().numpy()
    n = flat0.size
    m1 = rebalance(ShardMap(0, n), [1, 2])
    m2 = rebalance(m1, [1])
    worlds = {sid: InProcessTransport.create_world(2) for sid in (1, 2)}
    servers = {sid: ElasticShardServer(sid, n, worlds[sid][0], _MapFeed(), init_params=flat0)
               for sid in (1, 2)}
    for srv in servers.values():
        srv._apply_map(m1)
    feed = _MapFeed()
    opt = ShardedAsynchronous(model, lr=0.008, n_push=5, n_pull=5,
                              transports=[worlds[e.server_id][1] for e in m1.entries],
                              coord=feed, transport_factory=lambda e: worlds[e.server_id][1],
                              shard_map=m1)
    for listener in opt.listeners:
        listener.stop()
        listener.join(timeout=5)
    x, y = _k_batches(20, 16, seed=7)
    seen = []
    k1, fwd, bwd = tfu.launches, tfc.launches["relu_pool2_fwd.vector"], \
        tfc.launches["relu_pool2_bwd.vector"]
    for i in range(20):
        loss_and_grads(model, torch.from_numpy(x[i]).to(cuda), torch.from_numpy(y[i]).to(cuda))
        if i == 10:
            # the coordinator's map reaches the survivor and the worker
            servers[1]._apply_map(m2)
            feed.maps.append(m2)
            cut_flat = ravel_model_params(model).cpu().numpy()
        opt.step()
        opt._flusher.drain()
        for sid, w in worlds.items():
            while (m := w[0].recv(timeout=0.01)) is not None:
                seen.append((sid, m[1], m[2].size))
                if m[1] == MessageCode.RangeInstall:
                    fresh = m[2][4:].copy()
                if sid == 1 or i < 10:
                    servers[sid].handle(*m)
            for listener in opt.listeners:
                while (m := listener.transport.recv(timeout=0.01)) is not None:
                    listener.receive(*m)
    assert tfu.launches - k1 == 20
    assert tfc.launches["relu_pool2_fwd.vector"] - fwd == 60
    assert tfc.launches["relu_pool2_bwd.vector"] - bwd == 60
    assert opt.map_version == 2 and opt.ranges == [(0, n)]
    surv = servers[1]
    assert (surv.lo, surv.hi) == (0, n) and surv.stats["installs"] == 1
    # the install carried the worker's parameters of the step it cut over at
    np.testing.assert_array_equal(fresh, cut_flat[m1.entries[0].hi:])
    assert surv.stats["stale_dropped"] == 0
    pushes_v2 = [s for s in seen if s[0] == 1 and s[1] == MessageCode.ShardPush and s[2] == n + 6]
    assert len(pushes_v2) == 2  # steps 10 and 15
    opt._flusher.stop()


@pytest.mark.gpu
def test_elastic_scenario_on_the_card_counts_every_step(cuda):
    """``coord.demo.elastic_scenario`` with AlexNet on the card: two shards,
    two workers paced at 0.15 s a step, shard 2 crashing at worker 1's step
    4 of 20 (2.4 s before its end, against a 0.5 s lease). Every worker step
    runs K1 once and K2 three times each way; both workers end on the
    post-crash map and one install of the survivor's fresh range landed."""
    from distributed_ml_pytorch_tpu_torch.coord.demo import elastic_scenario

    _deterministic()
    k1, bwd = tfu.launches, tfc.launches["relu_pool2_bwd.vector"]
    out = elastic_scenario(steps=20, n_workers=2, n_shards=2, crash_shard_at=4, lease=0.5,
                           step_sleep=0.15, model="alexnet", device="cuda")
    assert out["ok"], out["errors"]
    assert tfu.launches - k1 == 40 and tfc.launches["relu_pool2_bwd.vector"] - bwd == 120
    assert out["worker_map_versions"] == {1: 3, 2: 3}
    assert out["stats"][1]["installs"] == 1
    assert out["stats"][1]["dup_installs"] == 1


@pytest.mark.gpu
def test_rollback_restore_behind_a_cuda_worker(cuda, tmp_path):
    """An AlexNet worker on the card pushes to a durable server (in-process
    transport); the server checkpoints after the third push, takes three
    more, and rolls back to apply seq 4: its vector is the checkpoint plus
    the fourth push bit for bit, the log keeps seq 4 only, and a fresh
    server restores the same vector from the files."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import Asynchronous, ParameterServer
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport, MessageCode
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    _deterministic()
    world = InProcessTransport.create_world(2)
    model = get_model("alexnet", fused_epilogue=True, seed=1, device=cuda)
    server = ParameterServer(params=ravel_model_params(model).cpu().numpy(),
                             transport=world[0], ckpt_dir=str(tmp_path), wal=True)
    opt = Asynchronous(model, lr=0.008, n_push=1, n_pull=1000, transport=world[1])
    install = world[0].recv(timeout=5)
    assert install[1] == MessageCode.ParameterUpdate
    server.handle(1, install[1], install[2])
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(64, 32, 32, 3, device=cuda, generator=g)
    y = torch.randint(0, 10, (64,), device=cuda, generator=g)
    pushes = []
    k1 = tfu.launches
    try:
        for step in range(6):
            loss_and_grads(model, x, y)
            opt.step()
            opt._flusher.drain()
            while True:
                msg = world[0].recv(timeout=5)
                assert msg is not None
                if msg[1] == MessageCode.GradientUpdate:
                    break
            pushes.append(msg[2].copy())
            server.handle(1, msg[1], msg[2])
            if step == 2:
                server.save_checkpoint()
                at_ckpt = server.central.copy()
        server.commit()
        assert tfu.launches - k1 == 6
        assert server.rollback_restore(4) == 2
        want = at_ckpt.copy()
        want += pushes[3]
        assert np.array_equal(server.central, want)
        assert [r.seq for r in server.wal.replay()[0]] == [4]
        fresh = ParameterServer(params=np.zeros_like(want), ckpt_dir=str(tmp_path), wal=True)
        assert fresh.maybe_restore() and fresh._apply_seq == 4
        assert np.array_equal(fresh.central, want)
    finally:
        opt._flusher.stop()
        for listener in opt.listeners:
            listener.stop()
        for t in world.values():
            t.close()


@pytest.mark.gpu
def test_recovery_drill_on_the_card(cuda, tmp_path):
    """``coord.drill.recovery_drill`` with AlexNet on the card at batch 64:
    every shard killed and restored from the manifest and its WAL, acked <=
    applied, every worker step running K1 once and K2 three times each way,
    and the chaos log the CPU run's (LeNet) byte for byte."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import default_drill_plan, recovery_drill

    _deterministic()
    k1, fwd = tfu.launches, tfc.launches["relu_pool2_fwd"]
    out = recovery_drill(base_dir=str(tmp_path / "card"), seed=0, plan=default_drill_plan(0),
                         model="alexnet", device="cuda", batch=64)
    assert out["ok"] and out["accounting_ok"] and out["replayed_updates"] > 0, out["errors"]
    steps = sum(len(v) for v in out["losses"].values())
    assert tfu.launches - k1 == steps and tfc.launches["relu_pool2_fwd"] - fwd == 3 * steps
    ref = recovery_drill(base_dir=str(tmp_path / "cpu"), seed=0, plan=default_drill_plan(0),
                         model="lenet", device="cpu")
    assert out["chaos_lines"] == ref["chaos_lines"]


@pytest.mark.gpu
def test_sched_drill_on_the_card(cuda, tmp_path):
    """``coord.drill.sched_drill`` with LeNet on the card: one preempt and
    one resume, a clean ledger, the resumed shard bit-identical to the
    parked one after replaying the log, acked <= applied, every worker step
    running K1 once, and the chaos log the CPU run's byte for byte."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import default_drill_plan, sched_drill

    k1 = tfu.launches
    out = sched_drill(base_dir=str(tmp_path / "card"), seed=0, plan=default_drill_plan(0),
                      model="lenet", device="cuda")
    assert out["ok"] and not out["violations"], (out["errors"], out["violations"])
    s = out["sched"]
    assert (s["preempts_done"], s["resumes_done"], s["audit"]) == (1, 1, [])
    assert out["replayed_updates"] > 0 and out["bit_identical"] is True
    assert all(a <= out["applied"][i][j] for i, w in out["acked"].items() for j, a in w.items())
    assert tfu.launches - k1 == sum(len(v) for v in out["losses"].values())
    ref = sched_drill(base_dir=str(tmp_path / "cpu"), seed=0, plan=default_drill_plan(0),
                      model="lenet", device="cpu")
    assert out["chaos_lines"] == ref["chaos_lines"]


@pytest.mark.gpu
def test_gray_drill_on_the_card(cuda, tmp_path):
    """``coord.drill.gray_drill`` with LeNet on the card: probation and
    quarantine, no eviction, a recovery, the resumed shard bit-identical,
    acked <= applied, every worker step running K1 once, and the chaos log
    the CPU run's byte for byte; the unmanaged leg puts no one on
    probation.

    The partition is a window of 56 worker steps, while the ladder takes
    about 2.8 s from the first suspicion to the park (two ticks to
    confirm, eight of probation, the snapshot barrier): in both packages
    the drill contains only if a step takes more than about 0.06 s, and
    LeNet on the card steps faster at the default 0.05 s pause (the
    ladder then clears probation before the park). The test pauses 0.08 s
    a step; the chaos log does not depend on the pace."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import gray_drill

    k1 = tfu.launches
    pace = dict(seed=0, model="lenet", step_sleep=0.08)
    out = gray_drill(base_dir=str(tmp_path / "card"), device="cuda", **pace)
    assert out["ok"] and not out["violations"], (out["errors"], out["violations"])
    g = out["gray"]
    assert g["probations"] >= 1 and g["quarantines"] >= 1 and g["evictions"] == 0
    assert g["recoveries"] >= 1 and out["bit_identical"] is True
    assert all(a <= out["applied"][i][j] for i, w in out["acked"].items() for j, a in w.items())
    assert tfu.launches - k1 == sum(len(v) for v in out["losses"].values())
    ref = gray_drill(base_dir=str(tmp_path / "cpu"), device="cpu", **pace)
    assert out["chaos_lines"] == ref["chaos_lines"]
    off = gray_drill(base_dir=str(tmp_path / "off"), device="cuda", contain=False, **pace)
    assert off["ok"] and off["gray"]["probations"] == 0


@pytest.mark.gpu
def test_fleet_migrates_token_identically_on_the_card(cuda):
    """Three engines of the serving CLI's default model behind a
    ``FleetRouter`` on the card, one crashed mid-stream: every greedy
    stream equals the same request run alone on one engine, a KvMigrate
    handoff carried it, and every decode step ran K8 (never the
    reference)."""
    import threading
    import time

    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.serving import cli as serving_cli
    from distributed_ml_pytorch_tpu_torch.serving.fleet import EngineMember, FleetRouter
    from distributed_ml_pytorch_tpu_torch.serving.frontend import ServingClient
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    args = serving_cli.parse_args(["--slots", "4"])
    lm = serving_cli.build_model(args)
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, args.vocab, size=int(rng.integers(4, 20))), 48) for _ in range(8)]
    solo = serving_cli.make_engine(lm, args)
    want = [solo.submit(p, n) for p, n in reqs]
    solo.run_until_idle()
    real_ref, ref_calls = da.decode_attention_reference, [0]

    def counted(*a, **k):
        ref_calls[0] += 1
        return real_ref(*a, **k)

    da.decode_attention_reference = counted
    world = InProcessTransport.create_world(2)
    members = [EngineMember(i, serving_cli.make_engine(lm, args)).start() for i in range(3)]
    router = FleetRouter(world[0], members, probe_timeout=30.0)
    thread = threading.Thread(target=router.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(world[1], resume_after=0.25)
        rids = [client.submit(p, n) for p, n in reqs]
        deadline = time.monotonic() + 60
        victim = None
        while victim is None and time.monotonic() < deadline:
            with router._routes_lock:
                live = [r.engine_id for r in router._routes.values()
                        if not r.done and r.engine_id >= 0 and len(r.tokens) >= 2]
            victim = live[0] if live else None
            time.sleep(0.002)
        assert victim is not None
        members[victim].crash()
        got = [list(client.stream(r, timeout=120)) for r in rids]
        assert got == [h.tokens for h in want]
        s = router.fleet_summary()
        assert s["migrations"] >= 1 and s["handoffs"] >= 1 and s["handoff_drops"] == 0
        assert ref_calls[0] == 0
    finally:
        da.decode_attention_reference = real_ref
        router.stop()
        thread.join(timeout=10)
        for t in world.values():
            t.close()


# ------------------------------------------------------------------ ResNet and the MoE LM

@pytest.mark.gpu
@pytest.mark.parametrize("name,size", [("resnet18", 32), ("resnet50", 72)])
def test_resnet_steps_on_the_card_equal_the_cpu_steps(cuda, name, size):
    """Two float32 SGD steps of the same seeded ResNet on the card (no TF32)
    and on the CPU: losses within 1e-4 relative; the bfloat16 model's steps
    on the card are finite and fall."""
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        SGD,
        create_train_state,
        make_train_step,
    )

    full_float32()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(8, size, size, 3)).astype(np.float32))
    y = torch.from_numpy(np.arange(8) % 10)
    losses = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32),
                       ("cuda", torch.bfloat16)):
        model = get_model(name, seed=0, device=dev, dtype=dtype, input_size=size)
        tx = SGD(0.001)
        state, step = create_train_state(model, tx), make_train_step(model, tx)
        losses[dev, dtype] = [float(step(state, x.to(dev), y.to(dev))[1]) for _ in range(3)]
    np.testing.assert_allclose(losses["cuda", torch.float32], losses["cpu", torch.float32],
                               rtol=1e-4)
    bf = losses["cuda", torch.bfloat16]
    assert np.isfinite(bf).all() and bf[-1] < bf[0]


@pytest.mark.gpu
def test_resnet18_downpour_step_launches_k1_once_a_step(cuda):
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import (
        default_downpour_tx,
        init_downpour_accumulator,
        make_downpour_device_step,
    )
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads

    model = get_model("resnet18", seed=0, device=cuda)
    tx = default_downpour_tx(0.001)
    opt_state = tx.init(list(model.parameters()))
    _flat, n, pad, accum = init_downpour_accumulator(model)
    assert n == 11_173_962 and (n + pad) % 128 == 0
    step = make_downpour_device_step(model, tx, n, pad)
    x = torch.randn(4, 32, 32, 3, device=cuda)
    y = torch.arange(4, device=cuda)
    before = tfu.launches
    for _ in range(3):
        loss_and_grads(model, x, y)
        step(opt_state, accum)
    torch.cuda.synchronize()
    assert tfu.launches == before + 3
    assert bool(torch.isfinite(accum).all()) and float(accum.abs().sum()) > 0


def _tiny_moe(device, dtype, seed=0, **kw):
    from distributed_ml_pytorch_tpu_torch.models import MoETransformerLM

    return MoETransformerLM(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                            n_experts=4, dtype=dtype, seed=seed, device=device, **kw)


@pytest.mark.gpu
def test_moe_step_on_the_card_runs_the_flash_kernels(cuda):
    """A bf16 MoE SGD step at 2 x 256 on the card launches K4 and K5 once a
    layer and never the plain versions; its loss is the CPU step's within
    2^-5 relative (bf16 attention and routing roundings)."""
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import create_lm_train_state
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    tok = torch.from_numpy(np.random.default_rng(2).integers(0, 128, (2, 256)))
    tgt = torch.roll(tok, -1, dims=1)
    losses = {}
    for dev in ("cpu", "cuda"):
        moe = _tiny_moe(dev, torch.bfloat16, max_len=256)
        tx = SGD(0.1)
        step = make_fsdp_lm_train_step(moe, tx)
        before = dict(tat.launches)
        _state, loss = step(create_lm_train_state(moe, tx), tok.to(dev), tgt.to(dev))
        losses[dev] = float(loss)
        counts = {k: tat.launches[k] - before[k] for k in before}
    assert counts == {"flash_fwd": 2, "flash_bwd_fused": 2, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=2.0 ** -5)


@pytest.mark.gpu
def test_moe_generate_on_the_card_equals_the_cpu_tokens(cuda):
    """Greedy float32 MoE decode on the blocked path: the card's tokens equal
    the CPU's, K8 once a layer and decode step, the reference never."""
    import importlib

    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as tda

    gen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, 128, (4, 12)))
    out = {}
    real_ref, ref_calls = tda.decode_attention_reference, [0]

    def counted(*a, **k):
        ref_calls[0] += 1
        return real_ref(*a, **k)

    for dev in ("cpu", "cuda"):
        moe = _tiny_moe(dev, torch.float32, seed=1, capacity_factor=4.0, max_len=64)
        tda.launches = 0
        ref_calls[0] = 0
        tda.decode_attention_reference = counted
        try:
            out[dev] = gen.generate(moe, prompt.to(dev), 33).cpu()
        finally:
            tda.decode_attention_reference = real_ref
        calls = (tda.launches, ref_calls[0])
    assert calls == (2 * 32, 0)
    assert torch.equal(out["cuda"], out["cpu"])


@pytest.mark.gpu
def test_one_rank_nccl_sync_and_fsdp_steps_equal_the_single_step(cuda):
    """A one-rank NCCL world (real NCCL groups, degenerate collectives): three
    sync-DP and three FSDP steps of the unfused AlexNet at b64, bit for bit
    the steps of ``training.trainer.make_train_step``."""
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel import fsdp, sync
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        SGD,
        create_train_state,
        make_train_step,
    )

    full_float32()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 32, 32, 3)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(np.arange(64) % 10).to(cuda)
    try:
        model = get_model("alexnet", seed=0, device=cuda)
        state, step = create_train_state(model, SGD(0.05)), make_train_step(model, SGD(0.05))
        want = [float(step(state, x, y)[1]) for _ in range(3)]

        def rank(world):
            mesh = make_mesh(world=world)
            out = []
            for mode in ("sync", "fsdp"):
                m = get_model("alexnet", seed=0, device=cuda)
                if mode == "sync":
                    st, stp = create_train_state(m, SGD(0.05)), sync.make_sync_train_step(
                        m, SGD(0.05), mesh)
                else:
                    st = fsdp.create_fsdp_train_state(m, SGD(0.05), mesh)
                    stp = fsdp.make_fsdp_train_step(m, SGD(0.05), mesh)
                losses = [float(stp(st, x, y)[1]) for _ in range(3)]
                if mode == "fsdp":
                    st.sharding.gather()
                out.append((losses, [p.detach().clone() for p in m.parameters()]))
            return out

        for losses, params in run_threaded(1, rank, backend="nccl", device="cuda")[0]:
            assert losses == want
            assert all(torch.equal(a, b) for a, b in zip(params, model.parameters()))
    finally:
        torch.backends.cudnn.deterministic = prev


@pytest.mark.gpu
def test_two_rank_tp_step_launches_k4_on_local_heads(cuda, tmp_path):
    """Two processes sharing the card over gloo, ``--mode tp`` at test widths
    (2 heads, one a rank): K4 and K5 once a layer and step on each rank, on
    the rank's one head, the plain attention never."""
    import chip_smoke as cs

    ranks, _ = cs._mesh_processes("cuda", True, "lm", str(tmp_path))
    for rank in ranks:
        rec = rank["lm"]["tp"]
        n = rec["launches"]
        assert n["flash_fwd"] == n["flash_bwd_fused"] == rec["layers"] * cs.MESH_LM_STEPS
        assert rec["plain_attention_calls"] == 0 and rec["heads"] == 1
        assert rec["q_shape"][0] == cs.TINY_MESH["lm_batch"] * rec["heads"]


def _pp_to_lm_state(state_dict):
    """A whole ``PipelineLM`` state dict under ``TransformerLM``'s names."""
    out = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            out[".".join([f"block_{parts[1]}"] + parts[2:])] = t
        else:
            out[{"ln_f": "LayerNorm_0", "head": "lm_head"}.get(parts[0], parts[0]) + "."
                + parts[-1]] = t
    return out


@pytest.mark.gpu
def test_one_rank_nccl_sp_and_pp_steps_equal_the_single_step(cuda):
    """A one-rank NCCL world: three sp steps (the ring of one chunk: K4 and
    K5 on the whole sequence) and three one-stage GPipe steps (one
    microbatch) of a float32 test-width LM equal the single-device LM step
    from the same weights."""
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.parallel import pipeline as pp
    from distributed_ml_pytorch_tpu_torch.parallel import seq_parallel as sp
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    full_float32()
    widths = dict(vocab_size=64, d_model=64, n_heads=2, n_layers=2, d_ff=128)
    tok = np.random.default_rng(0).integers(0, 64, (4, 256))
    tgt = sp.next_token_targets(tok)
    tt, tg = (torch.from_numpy(a.astype(np.int64)).to(cuda) for a in (tok, tgt))

    def single(state_dict=None):
        lm = TransformerLM(**widths, max_len=256, seed=0, device=cuda)
        if state_dict is not None:
            lm.load_state_dict(state_dict)
        state, step = sp.create_lm_train_state(lm, SGD(0.1)), make_fsdp_lm_train_step(
            lm, SGD(0.1))
        return [float(step(state, tt, tg)[1]) for _ in range(3)]

    cfg = pp.PipelineLMConfig(**widths, max_len=256)
    init = pp.init_pp_params(cfg, seed=0)

    def rank(world):
        mesh = make_mesh({"data": 1, "seq": 1}, world)
        lm = TransformerLM(**widths, max_len=256, seed=0, device=cuda)
        state, step = sp.create_lm_train_state(lm, SGD(0.1)), sp.make_sp_train_step(
            lm, SGD(0.1), mesh)
        a, b = sp.shard_lm_batch(mesh, tok, tgt)
        sp_losses = [float(step(state, a, b)[1]) for _ in range(3)]
        pmesh = make_mesh({"stage": 1}, world)
        pstate = pp.create_pp_train_state(cfg, SGD(0.1), pmesh, params=init)
        pstep = pp.make_pp_train_step(cfg, SGD(0.1), pmesh, 1)
        t, g = pp.microbatch(tok, tgt, 1)
        return sp_losses, [float(pstep(pstate, t, g)[1]) for _ in range(3)]

    sp_losses, pp_losses = run_threaded(1, rank, backend="nccl", device="cuda")[0]
    np.testing.assert_allclose(sp_losses, single(), rtol=1e-6)
    np.testing.assert_allclose(pp_losses, single(_pp_to_lm_state(init)), rtol=1e-5)


@pytest.mark.gpu
def test_two_rank_ring_launches_the_counted_k4_k5(cuda, tmp_path):
    """Two processes sharing the card over gloo, phase 27's 2-rank world at
    test widths: the causal ring launches K4 and K5 on one chunk a layer on
    rank 0 (the future chunk launches nothing) and on two on rank 1;
    Ulysses once a layer on each rank; a pipeline stage once a layer it
    holds and microbatch; the plain attention never; 1F1B's losses equal
    GPipe's. The ring's chunk, 96 tokens, is one no flash blocking divides:
    the kernels take it all the same (the fused K5 backward), never the
    plain blockwise ring."""
    import chip_smoke as cs

    ranks = cs._par_processes(cs.PAR_RANKS, "cuda", True, str(tmp_path))
    for r, rank in enumerate(ranks):
        assert rank["sp"]["rank_tokens"][1] % 128, rank["sp"]["rank_tokens"]
        for part, want in (("sp", rank["sp"]["layers"] * (r + 1) * cs.PAR_STEPS),
                           ("ulysses", rank["ulysses"]["layers"] * cs.PAR_STEPS),
                           ("pp_gpipe", rank["pp_gpipe"]["layers_here"]
                            * rank["pp_gpipe"]["microbatches"] * cs.PAR_STEPS)):
            rec = rank[part]
            n = rec["launches"]
            assert n["flash_fwd"] == n["flash_bwd_fused"] == want, (part, r, n)
            assert n["flash_bwd_dq"] == n["flash_bwd_dkv"] == 0, (part, r, n)
            assert rec["plain_attention_calls"] == 0, (part, r)
        np.testing.assert_allclose(rank["pp_1f1b"]["losses"], rank["pp_gpipe"]["losses"],
                                   rtol=cs.PAR_PP_RTOL)


def _mpmd_tiny(S=4, L=1, seq=128, d_model=64, n_heads=2):
    from distributed_ml_pytorch_tpu_torch.parallel.pipeline import PipelineLMConfig

    return PipelineLMConfig(vocab_size=64, d_model=d_model, n_heads=n_heads, n_layers=S * L,
                            d_ff=2 * d_model, max_len=seq)


@pytest.mark.gpu
def test_mpmd_fleet_launches_the_counted_k4_k5(cuda, tmp_path, monkeypatch):
    """A tiny 4-stage MPMD fleet on the card (each stage a thread of this
    process): the launches follow the schedule, not the port's code. A
    stage before the last runs K4 in each microbatch's forward and again in
    its recompute, and K5 in its backward: ``2·L·M·steps`` K4 and
    ``L·M·steps`` K5; the last stage fuses forward and backward: ``L·M·steps``
    of each. K6 0, the plain versions never, and the losses those of
    ``MpmdLocal`` on the card."""
    from distributed_ml_pytorch_tpu_torch.coord import stages as st
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.parallel import mpmd

    S, L, M, steps, mb, seq = 4, 1, 2, 2, 2, 128
    cfg = _mpmd_tiny(S, L, seq)
    toks, tgts = st.scenario_data(0, steps, M, mb, seq, cfg.vocab_size)
    local = mpmd.MpmdLocal(cfg, S, M, 0.1, 0, device="cuda")
    want = [local.step(t, g) for t, g in zip(toks, tgts)]
    plain = []
    for name in ("flash_fwd_plain", "flash_bwd_fused_plain", "flash_bwd_split_plain"):
        real = getattr(at, name)
        monkeypatch.setattr(at, name, lambda *a, _r=real, _n=name, **k: (plain.append(_n),
                                                                        _r(*a, **k))[1])
    for k in at.launches:
        at.launches[k] = 0
    out = st.mpmd_scenario(base_dir=str(tmp_path), seed=0, steps=steps, n_stages=S,
                           n_microbatches=M, mb=mb, seq=seq, cfg=cfg, device="cuda")
    n = dict(at.launches)
    assert out["ok"], (out["errors"], out["events"][-5:])
    assert n == {"flash_fwd": (S - 1) * 2 * L * M * steps + L * M * steps,
                 "flash_bwd_fused": S * L * M * steps, "flash_bwd_dq": 0,
                 "flash_bwd_dkv": 0}, n
    assert plain == []
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)


@pytest.mark.gpu
def test_mpmd_stage_program_raises_rather_than_run_plain(cuda):
    """A stage program on CUDA tensors whose attention no kernel can take
    (head_dim 20) raises; it never falls back to the plain version."""
    import distributed_ml_pytorch_tpu_torch.ops.attention as at
    from distributed_ml_pytorch_tpu_torch.parallel import mpmd

    cfg = _mpmd_tiny(S=2, d_model=40, n_heads=2)
    prog = mpmd.stage_programs(cfg, 0, 2, 1, 0.1)
    params = {k: v.to(cuda) for k, v in mpmd.init_stage_params(cfg, 0, 0, 2).items()}
    tokens = torch.zeros((2, 128), dtype=torch.long, device=cuda)
    before = dict(at.launches)
    with pytest.raises(ValueError, match="CUDA kernel"):
        prog.fwd(params, tokens)
    with pytest.raises(ValueError, match="CUDA kernel"):
        prog.bwd(params, tokens, torch.ones((2, 128, 40), device=cuda))
    assert dict(at.launches) == before


@pytest.mark.gpu
def test_trace_window_counts_k2_on_the_card(cuda, tmp_path):
    """A ``TraceWindow`` around two fused AlexNet trainer steps at b64: the
    exported trace holds K2a and K2b three times a step each, and one
    ``annotate_step`` range a step."""
    import json

    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        SGD,
        create_train_state,
        make_train_step,
    )
    from distributed_ml_pytorch_tpu_torch.utils.tracing import TraceWindow, annotate_step

    full_float32()
    model = get_model("alexnet", fused_epilogue=True, seed=0, device=cuda)
    state, step = create_train_state(model, SGD(0.008)), make_train_step(model, SGD(0.008))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 32, 32, 3)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(np.arange(64) % 10).to(cuda)
    float(step(state, x, y)[1])  # build and warm outside the window
    tw = TraceWindow(str(tmp_path / "prof"), start=1, n_steps=2)
    for i in range(4):
        tw.on_step(i)
        with annotate_step("train", i):
            float(step(state, x, y)[1])
        tw.after_step(i + 1)
    with open(tw.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k2 = [sum(f"relu_pool2_{d}" in k for k in kernels) for d in ("fwd", "bwd")]
    assert k2 == [6, 6], kernels
    # the host's ranges: the trace mirrors each on the GPU's timeline too
    assert sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                  and e["name"].startswith("train#")) == ["train#1", "train#2"]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_one_rank_nccl_sharded_resume_is_bit_for_bit(cuda, tmp_path, mode):
    """``train_lm --mode fsdp|tp`` on a one-rank NCCL world at test widths
    (bf16, the flash kernels, the split backward, which repeats bit for
    bit): 4 steps against 2, a sharded checkpoint and 2 resumed steps, the
    losses and the step-4 global trees equal."""
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import run_threaded
    from distributed_ml_pytorch_tpu_torch.training import train_lm
    from distributed_ml_pytorch_tpu_torch.utils.checkpoint import STATE_FILE

    base = ["--mode", mode, "--world-size", "1", "--vocab", "256", "--d-model", "128",
            "--n-heads", "2", "--n-layers", "2", "--d-ff", "256", "--seq", "256",
            "--batch", "4", "--dtype", "bfloat16", "--ckpt-every", "2"]

    def train(*argv):
        return run_threaded(1, lambda w: train_lm.run(train_lm.parse_args([*base, *argv]),
                                                      attn_fn=_split_attention()),
                            backend="nccl", device="cuda", timeout_s=300.0)[0]

    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    full = train("--steps", "4", "--ckpt-dir", whole)
    train("--steps", "2", "--ckpt-dir", cut)
    resumed = train("--steps", "2", "--ckpt-dir", cut, "--resume")
    assert resumed.start_step == 2 and resumed.losses == full.losses[2:]
    a, b = (torch.load(os.path.join(d, "4", STATE_FILE), weights_only=True)
            for d in (whole, cut))
    assert a["mode"] == mode and sorted(a["params"]) == sorted(b["params"])
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
