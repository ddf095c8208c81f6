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
    assert tfc.launches["relu_pool2_fwd"] == before["relu_pool2_fwd"] + 1
    assert tfc.launches["relu_pool2_bwd"] == before["relu_pool2_bwd"] + 1
    xr = torch.from_numpy(x).requires_grad_(True)
    br = torch.from_numpy(b).requires_grad_(True) if with_bias else None
    mr = tfc.relu_pool2(xr, br)
    mr.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(m.detach().cpu().numpy(), mr.detach().numpy())
    np.testing.assert_array_equal(xc.grad.cpu().numpy(), xr.grad.numpy())
    if with_bias:
        np.testing.assert_array_equal(bc.grad.cpu().numpy(), br.grad.numpy())


@pytest.mark.gpu
def test_relu_pool2_rejects_non_contiguous(cuda):
    x = torch.randn(2, 4, 4, 8, device=cuda).permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfc.relu_pool2(x)


@pytest.mark.gpu
def test_alexnet_fused_and_unfused_steps_agree(cuda):
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD, make_train_step
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    full_float32()
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(16, 32, 32, 3)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 10, size=16)).to(cuda)
    flats, losses = [], []
    for fused in (True, False):
        model = get_model("alexnet", fused_epilogue=fused, device=cuda)
        step = make_train_step(model, SGD(0.008))
        losses.append([float(step(x, y)) for _ in range(3)])
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
#: 2^-6 of the absolute product; atol is float32 summation noise.
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
@pytest.mark.parametrize("d", [32, 64, 128])
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
@pytest.mark.parametrize("bwd_impl", ["fused", "split"])
def test_flash_attention_autograd_on_the_card(cuda, bwd_impl):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat

    rng = np.random.default_rng(7)
    arrs = [rng.normal(size=(2, 3, 256, 64)).astype(np.float32) for _ in range(4)]
    before = dict(tat.launches)
    qc, kc, vc = (torch.from_numpy(a).to(cuda).requires_grad_(True) for a in arrs[:3])
    tat.flash_attention(qc, kc, vc, causal=True, bwd_impl=bwd_impl).backward(
        torch.from_numpy(arrs[3]).to(cuda))
    qr, kr, vr = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    out_r = tat.flash_attention(qr, kr, vr, causal=True, bwd_impl=bwd_impl)
    out_r.backward(torch.from_numpy(arrs[3]))
    torch.cuda.synchronize()
    launched = {n: tat.launches[n] - before[n] for n in before}
    if bwd_impl == "fused":
        assert launched == {"flash_fwd": 1, "flash_bwd_fused": 1, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}
    else:
        assert launched == {"flash_fwd": 1, "flash_bwd_fused": 0, "flash_bwd_dq": 1,
                            "flash_bwd_dkv": 1}
    for got, want in ((qc.grad, qr.grad), (kc.grad, kr.grad), (vc.grad, vr.grad)):
        _close(got, want, torch.float32, "grad")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,exc", [(torch.float16, 64, TypeError),
                                         (torch.float32, 16, ValueError),
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
    # the default 8 heads of d_model 128 give head_dim 16, which the kernels
    # do not take; 4 heads give 32
    res = train_lm.run(train_lm.parse_args(
        ["--steps", "3", "--dtype", "bfloat16", "--pos-encoding", "rope", "--lr", "0.5",
         "--n-heads", "4"]))
    assert all(np.isfinite(res.losses)) and res.losses[-1] < res.losses[0]
    assert tat.launches["flash_fwd"] - before["flash_fwd"] == 2 * 3
    assert tat.launches["flash_bwd_fused"] - before["flash_bwd_fused"] == 2 * 3


@pytest.mark.gpu
def test_kernel_breakdown_sees_the_card(cuda):
    from distributed_ml_pytorch_tpu_torch.ops import attention as tat
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    q = torch.randn(4, 512, 64, device=cuda)
    res = kernel_breakdown(lambda: tat.flash_fwd_cuda(q, q, q, True),
                           {"K4": ["flash_fwd_kernel"]})
    assert res["group_ms"]["K4"] > 0 and res["busy_ms"] <= res["wall_ms"]
    assert 0.0 <= res["idle_share"] < 1.0
