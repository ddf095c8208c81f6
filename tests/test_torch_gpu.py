"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``gpu`` and skips without a card (decided in the
``cuda`` fixture, never at import). This file imports neither JAX nor the
JAX package, nor needs ``tests/conftest.py``, so it runs on a machine with
PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

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
                                         (torch.float32, 8, ValueError),
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
