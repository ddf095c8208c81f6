"""The tensor-core fused backward (K5, ``csrc/flash_bwd_tc.cu``) where
``dS = p·(dP − delta)`` cancels, and what its two numerical choices cost.

    python -m distributed_ml_pytorch_tpu_torch.bench_k5_numerics

Three builds of the kernel, each a copy of the source with one constant or
line rewritten, built by ``nvcc`` with the port's flags under
``build/k5_numerics/`` (the package's kernel is not touched):

- ``package``: as shipped;
- ``no_recompute``: ``kCancel = 0``, so no dP is recomputed in order;
- ``scalar_atomics``: dQ added with two f32 ``atomicAdd`` instead of one
  float2.

1. One-key heads (sq = sk = 1, causal: the exact dS is 0): for 65,535
   random bfloat16 heads at each head_dim, how many heads' dQ miss
   ``chip_smoke.ATTN_TOL`` against ``flash_bwd_fused_plain``, for each build
   and for the package's split-dQ kernel K6a (the tensor-core
   ``flash_bwd_dq_tc_kernel``, which shares K5's in-order recompute),
   against the plain version as shipped (dP summed in order of d) and
   against one whose dP is a library product (``torch.matmul``).
2. GPT-2-small's own K5 inputs (the first backward launch of a
   ``training.train_lm`` step, bf16, b8 h12 s2048 d64) and random inputs of
   that shape: the pairs whose float32 ``|dP − delta|`` is below
   ``2^-16·|dP|`` (what the kernel recomputes, up to its own dP's rounding),
   and each build's time (``utils/devtime``, in turns).

Prints one JSON object (``train_lm``'s own lines go to stderr). Needs a
card.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys

import torch

HEAD_DIMS = (16, 32, 64, 128)
HEADS = 65535
ATOL, RTOL = 1e-6, 2.0 ** -6  # chip_smoke.ATTN_TOL["bfloat16"]
CANCEL = "constexpr float kCancel = 1.0f / 65536.0f;"
FLOAT2_ADD = """                    atomicAdd(reinterpret_cast<float2*>(dst + j * 8),
                              make_float2(dq[j][2 * i], dq[j][2 * i + 1]));"""
SCALAR_ADD = """                    atomicAdd(dst + j * 8, dq[j][2 * i]);
                    atomicAdd(dst + j * 8 + 1, dq[j][2 * i + 1]);"""
EDITS = {"package": (), "no_recompute": ((CANCEL, "constexpr float kCancel = 0.0f;"),),
         "scalar_atomics": ((FLOAT2_ADD, SCALAR_ADD),)}


def build_variants(root):
    """``{name: entry point}``, built in parallel."""
    from distributed_ml_pytorch_tpu_torch.ops import _build
    from distributed_ml_pytorch_tpu_torch.ops import attention as at

    src = (_build.CSRC / "flash_bwd_tc.cu").read_text()
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old.strip()!r}")
            text = text.replace(old, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "tc_frag.cuh").write_text((_build.CSRC / "tc_frag.cuh").read_text())
        (d / "k.cu").write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "k.so"), str(d / "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(d / "k.so")).dmt_flash_bwd_tc
        fn.argtypes = at._argtypes("dmt_flash_bwd_tc")
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def main() -> int:
    from distributed_ml_pytorch_tpu_torch.ops import _build
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.training import train_lm
    from distributed_ml_pytorch_tpu_torch.utils.devtime import device_time

    if not torch.cuda.is_available():
        print("bench_k5_numerics: needs a CUDA card", file=sys.stderr)
        return 2
    fns = build_variants(_build.BUILD_ROOT.parent / "k5_numerics")

    def launch(fn, q, k, v, do, lse, delta, causal):
        bh, sq, d = q.shape
        dq = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq,
                k.shape[1], d, int(causal), 1, *at._scales(d), _build.stream_of(q))
        _build.check(rc, "flash fused backward variant")
        return dq.to(q.dtype)

    kernels = {**{n: (lambda *a, fn=fn: launch(fn, *a)) for n, fn in fns.items()},
               "k6a": at.flash_bwd_dq_cuda}
    in_order = at._dp_in_order
    matmul = lambda do, v: torch.matmul(do.float(), v.float().transpose(-1, -2))
    g = torch.Generator(device="cuda").manual_seed(0)
    one_key = {}
    for d in HEAD_DIMS:
        q, k, v, do = (torch.randn((HEADS, 1, d), generator=g, device="cuda").bfloat16()
                       for _ in range(4))
        out_p, lse = at.flash_fwd_plain(q, k, v, True)
        args = (q, k, v, do, lse, (do.float() * out_p.float()).sum(-1), True)
        scale = at.flash_error_scales(*args)["dq"]
        got = {n: fn(*args).float() for n, fn in kernels.items()}
        res = {}
        for ref, dp_fn in (("in_order", in_order), ("matmul", matmul)):
            at._dp_in_order = dp_fn
            try:
                want = at.flash_bwd_fused_plain(*args)[0].float()
            finally:
                at._dp_in_order = in_order
            res[ref] = {n: int(((x - want).abs() > ATOL + RTOL * scale).any(-1).sum())
                        for n, x in got.items()}
        one_key[d] = res

    captured = []
    real = at.flash_bwd_fused_cuda

    def spy(*args):
        if not captured:
            captured.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args)

    at.flash_bwd_fused_cuda = spy
    try:
        with contextlib.redirect_stdout(sys.stderr):
            train_lm.run(train_lm.parse_args([
                "--vocab", "50304", "--d-model", "768", "--n-heads", "12", "--n-layers", "12",
                "--d-ff", "3072", "--dtype", "bfloat16", "--pos-encoding", "rope",
                "--batch", "8", "--seq", "2048", "--steps", "2"]))
    finally:
        at.flash_bwd_fused_cuda = real
    model_args = captured[0]
    q, k, v, do = (torch.randn(model_args[0].shape, generator=g, device="cuda").bfloat16()
                   for _ in range(4))
    out_p, lse = at.flash_fwd_plain(q, k, v, True)
    inputs = {"gpt2_small_step": model_args,
              "random": (q, k, v, do, lse, (do.float() * out_p.float()).sum(-1), True)}
    step = {}
    for key, args in inputs.items():
        q, k, v, do, lse, delta, causal = args
        p = torch.exp2(at._scores_log2(q, k, causal) - lse.unsqueeze(-1))
        dp = matmul(do, v)
        flagged = int(((p > 0) & ((dp - delta.unsqueeze(-1)).abs() < 2.0 ** -16 * dp.abs()))
                      .sum())
        live = int((p > 0).sum())
        del p, dp
        ms = {n: [] for n in fns}
        for n in [*fns, *reversed(list(fns))]:
            ms[n].append(device_time(lambda n=n: launch(fns[n], *args), calls=20,
                                     warmup=3).per_call_ms)
        step[key] = {"pairs": live, "recomputed": flagged, "ms": ms}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "heads": HEADS,
                      "one_key_heads_missing_tol": one_key, "lm_shape": step}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
