"""Flash attention, the blockwise online-softmax scan and the model-facing
selector (counterpart of the JAX ``ops/attention.py``).

All functions take ``(batch, heads, seq, head_dim)`` tensors, as the JAX ones
do.

- :func:`flash_attention` / :func:`flash_attention_lse`: differentiable flash
  attention (a ``torch.autograd.Function``). On CUDA tensors the forward is
  K4 and the backward the fused K5 kernel or the split pair K6a (dQ) + K6b
  (dK/dV); on CPU tensors the plain versions :func:`flash_fwd_plain`,
  :func:`flash_bwd_fused_plain` and :func:`flash_bwd_split_plain` run
  instead. For bfloat16, K4 is the tensor-core kernel of
  ``csrc/flash_fwd_tc.cu``, and K5, K6a and K6b those of
  ``csrc/flash_bwd_tc.cu`` (mma.sync, cp.async; K6b is K5 without its dQ,
  and its dK and dV are K5's bit for bit; K6a keeps dQ in registers over
  the key tiles, with no atomics); for float32 they are the scalar kernels
  of ``csrc/attention.cu``, because the tensor cores have no mode that keeps
  float32's numbers (TF32 keeps about three decimal digits, against the
  float32 tolerance of 1e-5). On a CUDA tensor an op launches its kernel or
  raises (a dtype other than float32/bfloat16, a head_dim other than
  16/32/64/128 (or 8 in float32), a tensor that is not contiguous, a
  bfloat16 operand not
  16-byte aligned); it never runs the plain version or another kernel
  there.
- :func:`blockwise_attention`: the same online-softmax recurrence as a loop
  over key blocks in plain PyTorch, returning the un-finalized ``(acc, m, l)``
  carry with query/key offsets (what ring attention folds chunks into).
- :func:`auto_attention`: the model's default. On a CUDA tensor it is always
  the flash kernels, at any sequence length (their 64-row tiles mask a
  ragged end). On a CPU tensor it takes the flash plain versions when
  ``flash_block_choice`` finds a blocking (and, if causal, ``sq == sk``), and
  the blockwise scan otherwise, as the JAX selector does on a TPU.
- :func:`attention_reference`: the naive softmax(QKᵀ/√d)V.

The block arguments are validated exactly as the TPU kernel validated them
(``_resolve_flash_config``: explicit blocks must divide the sequence, causal
needs ``sq == sk``) and they decide ``bwd_impl=None`` the same way: "split"
once the fused backward's dq-partials buffer, ``(sk/block_k_bwd)·b·h·sq·d``
f32, would pass :data:`FUSED_BWD_PARTIALS_CAP`. The CUDA kernels tile by 64
on their own and take any length; K5 adds dQ with f32 atomics in both
dtypes instead of writing partials (see its sources' headers); the split
pair has no atomics.
``interpret`` is accepted and ignored.

Numerics are the TPU kernel's: f32 scores in log2 space, ``p`` rounded to
V's dtype before the PV product, ``dS`` rounded to the input dtype before
the dK and dQ products, the lse kept base 2 inside and returned in natural
log by :func:`flash_attention_lse`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from distributed_ml_pytorch_tpu_torch.ops import _build

NEG_INF = -1e30
LOG2_E = 1.4426950408889634  # scores are kept in log2 space inside the kernels
# ceiling on the fused backward's dq-partials buffer of the TPU kernel; above
# it the buffer-free split backward is auto-selected
FUSED_BWD_PARTIALS_CAP = 6 * 1024**3
#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: the float32 kernels (``csrc/attention.cu``) also take head_dim 8, the JAX
#: MPMD scenario's width
FLOAT32_HEAD_DIMS = (8, *KERNEL_HEAD_DIMS)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernels (plain versions do not count):
#: K4 forward, K5 fused backward, K6a split dQ, K6b split dK/dV
launches = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
_LAUNCH_LOCK = threading.Lock()


def _count(name: str) -> None:
    """One launch of ``name``, under a lock: the wrappers run on several
    threads at once (an MPMD stage member each)."""
    with _LAUNCH_LOCK:
        launches[name] += 1


# ------------------------------------------------------------------ reference and scan

def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False) -> torch.Tensor:
    """Naive softmax(QKᵀ/√d)V — the ground truth for kernel tests."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def init_softmax_state(q: torch.Tensor):
    """Empty online-softmax state ``(m, l, acc)`` for queries ``q``, in f32."""
    l0 = torch.zeros(q.shape[:-1] + (1,), dtype=torch.float32, device=q.device)
    return l0 + NEG_INF, l0, torch.zeros(q.shape, dtype=torch.float32, device=q.device)


def _online_update(m, l, acc, s, v_blk):
    """One online-softmax step: fold scores ``s`` (…q,k) and values ``v_blk``
    (…k,d) into the running (max, normalizer, accumulator). Entries at
    ``NEG_INF`` (masked) contribute exactly zero even when the whole row is
    masked."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new), torch.zeros((), device=s.device))
    correction = torch.exp(torch.clamp(m - m_new, min=NEG_INF))
    l_new = l * correction + p.sum(dim=-1, keepdim=True)
    acc_new = acc * correction + torch.einsum("...qk,...kd->...qd", p, v_blk.float())
    return m_new, l_new, acc_new


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, block_k: int = 512, q_offset=0, k_offset=0):
    """Differentiable online-softmax attention over key blocks.

    Returns ``(out, m, l)`` — the un-finalized accumulator statistics, always
    float32 — so further key chunks can be folded in; finalize with
    :func:`finalize_attention`. ``q_offset``/``k_offset`` are the global
    positions of element 0 of the local q/k chunks (the causal mask of a
    sharded sequence).
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    block_k = min(block_k, sk)
    n_blocks = -(-sk // block_k)
    pad = n_blocks * block_k - sk
    if pad:
        # padded keys are masked off via their out-of-range global position
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    scale = d ** -0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)
    qf = q.float()
    m, l, acc = init_softmax_state(q)
    for j in range(n_blocks):
        k_blk = k[:, :, j * block_k:(j + 1) * block_k]
        v_blk = v[:, :, j * block_k:(j + 1) * block_k]
        # scores and statistics in f32 even for bf16 inputs
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float()) * scale
        k_pos = k_offset + j * block_k + torch.arange(block_k, device=q.device)
        valid = k_pos < k_offset + sk
        if causal:
            valid = valid[None, :] & (k_pos[None, :] <= q_pos[:, None])
        else:
            valid = valid[None, :].expand(sq, block_k)
        s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
        m, l, acc = _online_update(m, l, acc, s, v_blk)
    return acc, m, l


def finalize_attention(acc: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Normalize the online-softmax accumulator into attention output."""
    return acc / torch.clamp(l, min=1e-30)


def scan_attn_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention via the blockwise scan, finalized (plain ops only)."""
    acc, _m, l = blockwise_attention(q, k, v, causal=True)
    return finalize_attention(acc, l).to(q.dtype)


# ------------------------------------------------------------------ block choice

def _side_block_choice(n: int):
    """Largest swept block size dividing one sequence side, or None — the
    single candidate list every default blocking derives from."""
    return next((c for c in (1024, 512, 256, 128) if n % c == 0), None)


def flash_block_choice(sq: int, sk: int):
    """Forward ``(block_q, block_k)`` dividing the sequence lengths, or None
    when no legal blocking exists (then :func:`auto_attention` takes the
    scan)."""
    bq, bk = _side_block_choice(sq), _side_block_choice(sk)
    return None if bq is None or bk is None else (bq, bk)


def flash_bwd_block_choice(sq: int, sk: int):
    """Backward blocking: the forward's, except ``(·, 2048)`` key blocks at
    ``sk == 8192`` exactly (the TPU sweep's winner there)."""
    choice = flash_block_choice(sq, sk)
    if choice is not None and sk == 8192:
        return (choice[0], 2048)
    return choice


def _resolve_flash_config(q, k, causal, block_q, block_k, block_q_bwd, block_k_bwd, bwd_impl):
    """Default resolution and validation shared by the flash entry points:
    ``((block_q, block_k), (block_q_bwd, block_k_bwd), bwd_impl)``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if causal and sq != sk:
        raise ValueError(f"causal flash_attention requires sq == sk, got {sq} != {sk}")

    def _default(n, name):
        c = _side_block_choice(n)
        if c is None:
            raise ValueError(
                f"no flash blocking divides {name}={n}; pass an explicit "
                "block or pad the sequence (auto_attention falls back to "
                "the scan for such shapes)"
            )
        return c

    if block_q is None:
        block_q = _default(sq, "sq")
    if block_k is None:
        block_k = _default(sk, "sk")
    if block_q_bwd is None or block_k_bwd is None:
        bwd_default = flash_bwd_block_choice(sq, sk)
        if block_q_bwd is None:
            block_q_bwd = bwd_default[0] if bwd_default else block_q
        if block_k_bwd is None:
            block_k_bwd = bwd_default[1] if bwd_default else block_k
    if sq % block_q or sk % block_k or sq % block_q_bwd or sk % block_k_bwd:
        raise ValueError(
            f"flash_attention needs seq multiples of block sizes, got "
            f"sq={sq}%{block_q}/{block_q_bwd}, sk={sk}%{block_k}/{block_k_bwd}"
        )
    if bwd_impl is None:
        partials = (sk // block_k_bwd) * b * h * sq * d * 4
        bwd_impl = "split" if partials > FUSED_BWD_PARTIALS_CAP else "fused"
    if bwd_impl not in ("fused", "split"):
        raise ValueError(f"bwd_impl must be 'fused' or 'split', got {bwd_impl!r}")
    return (block_q, block_k), (block_q_bwd, block_k_bwd), bwd_impl


# ------------------------------------------------------------------ plain versions

def _scores_log2(q, k, causal):
    """f32 scores in log2 space over flattened heads, masked to NEG_INF."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5 * LOG2_E)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full((), NEG_INF, device=s.device))
    return s


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool):
    """K4's function over ``(b·h, s, d)``: ``(out in q's dtype, base-2 lse
    (b·h, sq) f32)``, with ``p`` rounded to V's dtype before the PV product."""
    s = _scores_log2(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def _dp_in_order(do, v):
    """``do·vᵀ`` in f32, summed over d in order with one rounding per term:
    the scalar kernels' FMA chain (a bfloat16 product is exact in f32, so
    each step rounds once, as an FMA does)."""
    dof, vf = do.float(), v.float()
    dp = torch.zeros(dof.shape[:-1] + (vf.shape[-2],), dtype=torch.float32, device=do.device)
    for i in range(dof.shape[-1]):
        dp += dof[..., :, i, None] * vf[..., None, :, i]
    return dp


def flash_bwd_fused_plain(q, k, v, do, lse2, delta, causal: bool):
    """K5's function: ``(dq, dk, dv)`` from the base-2 ``lse2`` and
    ``delta = rowsum(do·o) − dlse``, both ``(b·h, sq)`` f32. ``p`` is
    recomputed from the lse, rounded to dO's dtype for dV; ``dS`` is rounded
    to the input dtype for dK and dQ; dQ is summed in f32 and cast last.

    ``dP = do·vᵀ`` is summed in order of d (:func:`_dp_in_order`), not by a
    library product: ``dS = p·(dP − delta)`` cancels where dP ≈ delta (at a
    query that sees one key its exact value is 0), and there only a fixed
    order makes the f32 noise the kernels' own (they sum that dP the same
    way)."""
    p = torch.exp2(_scores_log2(q, k, causal) - lse2.unsqueeze(-1))
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = _dp_in_order(do, v)
    ds = (p * (dp - delta.unsqueeze(-1))) * (q.shape[-1] ** -0.5)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_split_plain(q, k, v, do, lse2, delta, causal: bool):
    """K6a + K6b's function: the same ``(dq, dk, dv)`` as
    :func:`flash_bwd_fused_plain` — the split kernels differ from the fused
    one only in how the work is divided (scores recomputed twice, dQ summed
    in a fixed order), not in what they compute."""
    return flash_bwd_fused_plain(q, k, v, do, lse2, delta, causal)


def flash_error_scales(q, k, v, do, lse2, delta, causal: bool):
    """The absolute products that bound each kernel output's rounding error,
    f32 over ``(b·h, s, d)``: ``P·|V|`` for out, ``|dS|·|K|`` for dQ,
    ``|dS|ᵀ·|Q|`` for dK and ``Pᵀ·|dO|`` for dV. Rounding the terms of a sum
    (p or dS to bfloat16) by a relative ``u`` each moves the sum by at most
    ``u`` times its absolute product, so an output that cancels to near
    zero is held at the scale of its terms, not at its own."""
    p = torch.exp2(_scores_log2(q, k, causal) - lse2.unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta.unsqueeze(-1))).abs() * (q.shape[-1] ** -0.5)
    return {"out": torch.matmul(p, v.float().abs()),
            "dq": torch.matmul(ds, k.float().abs()),
            "dk": torch.matmul(ds.transpose(-1, -2), q.float().abs()),
            "dv": torch.matmul(p.transpose(-1, -2), do.float().abs())}


def flash_plain_rows(q, k, v, do, lse2, delta, causal: bool, rows: int = 2048) -> dict:
    """The plain versions and their error scales, one block of ``rows``
    query rows at a time, for lengths whose whole ``(sq, sk)`` score plane
    does not fit (32768² f32 is 4 GiB a head): over ``(n, s, d)``
    (typically one head, ``n = 1``) it returns ``out`` and ``lse`` (base 2)
    as :func:`flash_fwd_plain` computes them, ``dq``, ``dk`` and ``dv`` as
    :func:`flash_bwd_fused_plain` computes them from the given ``lse2`` and
    ``delta``, and the scales of :func:`flash_error_scales` (``out`` from
    the forward's own lse). dK, dV and their scales are summed over the
    blocks in float32; every other value of a row depends on that row
    alone."""
    n, sq, d = q.shape
    sk = k.shape[1]
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    dq = torch.empty_like(q)
    lse = torch.empty((n, sq), dtype=torch.float32, device=q.device)
    dk = torch.zeros((n, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    scales = {"out": torch.empty_like(out, dtype=torch.float32),
              "dq": torch.empty_like(out, dtype=torch.float32),
              "dk": torch.zeros_like(dk), "dv": torch.zeros_like(dk)}
    key_pos = torch.arange(sk, device=q.device)
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        qc, doc = q[:, r0:r1], do[:, r0:r1]
        s = torch.matmul(qc.float(), kf.transpose(-1, -2)) * (d ** -0.5 * LOG2_E)
        if causal:
            keep = key_pos[None, :] <= torch.arange(r0, r1, device=q.device)[:, None]
            s = torch.where(keep, s, torch.full((), NEG_INF, device=s.device))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        out[:, r0:r1] = (torch.matmul(p.to(v.dtype).float(), vf) / l).to(q.dtype)
        lse[:, r0:r1] = (m + torch.log2(l)).squeeze(-1)
        scales["out"][:, r0:r1] = torch.matmul(p / l, vf.abs())
        p = torch.exp2(s - lse2[:, r0:r1, None])
        del s
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), doc.float())
        scales["dv"] += torch.matmul(p.transpose(-1, -2), doc.float().abs())
        ds = (p * (_dp_in_order(doc, v) - delta[:, r0:r1, None])) * (d ** -0.5)
        dk += torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qc.float())
        dq[:, r0:r1] = torch.matmul(ds.to(k.dtype).float(), kf).to(q.dtype)
        del ds
        dp = torch.matmul(doc.float(), vf.transpose(-1, -2))
        ds_abs = (p * (dp - delta[:, r0:r1, None])).abs() * (d ** -0.5)
        del dp, p
        scales["dq"][:, r0:r1] = torch.matmul(ds_abs, kf.abs())
        scales["dk"] += torch.matmul(ds_abs.transpose(-1, -2), qc.float().abs())
    return {"out": out, "lse": lse, "dq": dq, "dk": dk.to(k.dtype), "dv": dv.to(v.dtype),
            "scales": scales}


# ------------------------------------------------------------------ CUDA kernels

def _check_cuda(name: str, tensors, lse_like=()) -> int:
    """Raise unless the kernel takes these tensors; return the dtype code."""
    q = tensors[0]
    for t in (*tensors, *lse_like):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} needs every tensor on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors; got strides {t.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: q, k, v (and do) must share one dtype")
    if any(t.dtype != torch.float32 for t in lse_like):
        raise TypeError(f"{name}: lse and delta must be float32")
    d = q.shape[-1]
    dims = FLOAT32_HEAD_DIMS if q.dtype == torch.float32 else KERNEL_HEAD_DIMS
    if q.dim() != 3 or d not in dims:
        raise ValueError(f"{name}: the CUDA kernel takes (b*h, s, d) with d in {dims} "
                         f"for {q.dtype}, got shape {tuple(q.shape)}")
    bh, sq, _ = q.shape
    k, v = tensors[1], tensors[2]
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"{name}: k and v must be (b*h, sk, {d}) with b*h = {bh}")
    if len(tensors) > 3 and tensors[3].shape != q.shape:
        raise ValueError(f"{name}: do must have q's shape {tuple(q.shape)}")
    if any(t.shape != (bh, sq) for t in lse_like):
        raise ValueError(f"{name}: lse and delta must be ({bh}, {sq})")
    return _DTYPE_CODES[q.dtype]


#: C entry point -> (library, pointer arguments)
_ARGTYPES = {
    "dmt_flash_fwd": ("attention", 5),
    "dmt_flash_fwd_tc": ("flash_fwd_tc", 5),
    "dmt_flash_bwd_fused": ("attention", 9),
    "dmt_flash_bwd_tc": ("flash_bwd_tc", 9),
    "dmt_flash_bwd_dq": ("attention", 7),
    "dmt_flash_bwd_dq_tc": ("flash_bwd_tc", 7),
    "dmt_flash_bwd_dkv": ("attention", 8),
    "dmt_flash_bwd_dkv_tc": ("flash_bwd_tc", 8),
}


def _argtypes(name: str):
    """The ctypes argument list of a C entry point: its tensor pointers, six
    ints (b*h, sq, sk, d, causal, dtype), its scales and the stream."""
    n_ptrs = _ARGTYPES[name][1]
    n_floats = 1 if name.startswith("dmt_flash_fwd") else 2
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
            + [ctypes.c_float] * n_floats + [ctypes.c_void_p])


def _fn(name: str):
    fn = getattr(_build.load(_ARGTYPES[name][0]), name)
    fn.argtypes = _argtypes(name)
    fn.restype = ctypes.c_int
    return fn


def _check_aligned(what: str, named) -> None:
    """Raise unless every tensor starts 16-byte aligned (the tensor-core
    kernels' ``cp.async`` copies); outputs and scratch come from the caching
    allocator, which aligns them."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned for the "
                             f"tensor-core kernel, got offset {t.data_ptr() % 16}")


def _scales(d: int):
    return d ** -0.5 * LOG2_E, d ** -0.5


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool):
    """Launch K4 on contiguous ``(b·h, s, d)`` CUDA tensors: ``(out, lse2)``.
    bfloat16 goes to the tensor-core kernel, whose ``cp.async`` copies need
    every operand 16-byte aligned; float32 to the scalar kernel."""
    code = _check_cuda("flash forward", (q, k, v))
    bh, sq, d = q.shape
    if causal and k.shape[1] != sq:
        raise ValueError("causal flash attention requires sq == sk")
    out = torch.empty_like(q)
    lse2 = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    entry = "dmt_flash_fwd"
    if q.dtype == torch.bfloat16:
        entry = "dmt_flash_fwd_tc"
        _check_aligned("flash forward", (("q", q), ("k", k), ("v", v)))
    with torch.cuda.device(q.device):
        rc = _fn(entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        lse2.data_ptr(), bh, sq, k.shape[1], d, int(causal), code,
                        _scales(d)[0], _build.stream_of(q))
    _build.check(rc, "flash forward")
    _count("flash_fwd")
    return out, lse2


def _bwd_prologue(name, q, k, v, do, lse2, delta, causal):
    code = _check_cuda(name, (q, k, v, do), (lse2, delta))
    if causal and k.shape[1] != q.shape[1]:
        raise ValueError("causal flash attention requires sq == sk")
    return code


def flash_bwd_fused_cuda(q, k, v, do, lse2, delta, causal: bool):
    """Launch K5: ``(dq, dk, dv)``; dQ is accumulated in an f32 buffer with
    atomics and cast to q's dtype after the launch. bfloat16 goes to the
    tensor-core kernel, whose ``cp.async`` copies need q, k, v and do 16-byte
    aligned; float32 to the scalar kernel."""
    code = _bwd_prologue("flash fused backward", q, k, v, do, lse2, delta, causal)
    entry = "dmt_flash_bwd_fused"
    if q.dtype == torch.bfloat16:
        entry = "dmt_flash_bwd_tc"
        _check_aligned("flash fused backward", (("q", q), ("k", k), ("v", v), ("do", do)))
    bh, sq, d = q.shape
    dq_acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _fn(entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, sq, k.shape[1], d, int(causal), code, *_scales(d), _build.stream_of(q))
    _build.check(rc, "flash fused backward")
    _count("flash_bwd_fused")
    return dq_acc.to(q.dtype), dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse2, delta, causal: bool):
    """Launch K6a: dQ, summed in registers over the key tiles (deterministic:
    no atomics). bfloat16 goes to the tensor-core kernel, whose ``cp.async``
    copies need q, k, v and do 16-byte aligned; float32 to the scalar
    kernel."""
    code = _bwd_prologue("flash split backward (dq)", q, k, v, do, lse2, delta, causal)
    entry = "dmt_flash_bwd_dq"
    if q.dtype == torch.bfloat16:
        entry = "dmt_flash_bwd_dq_tc"
        _check_aligned("flash split backward (dq)",
                       (("q", q), ("k", k), ("v", v), ("do", do)))
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _fn(entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), bh, sq, k.shape[1], d, int(causal), code,
            *_scales(d), _build.stream_of(q))
    _build.check(rc, "flash split backward (dq)")
    _count("flash_bwd_dq")
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse2, delta, causal: bool):
    """Launch K6b: ``(dk, dv)`` (deterministic). bfloat16 goes to the
    tensor-core kernel (K5's without dQ: the same dK and dV bit for bit),
    whose ``cp.async`` copies need q, k, v and do 16-byte aligned; float32 to
    the scalar kernel."""
    code = _bwd_prologue("flash split backward (dk/dv)", q, k, v, do, lse2, delta, causal)
    entry = "dmt_flash_bwd_dkv"
    if q.dtype == torch.bfloat16:
        entry = "dmt_flash_bwd_dkv_tc"
        _check_aligned("flash split backward (dk/dv)",
                       (("q", q), ("k", k), ("v", v), ("do", do)))
    bh, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _fn(entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, k.shape[1], d,
            int(causal), code, *_scales(d), _build.stream_of(q))
    _build.check(rc, "flash split backward (dk/dv)")
    _count("flash_bwd_dkv")
    return dk, dv


# ------------------------------------------------------------------ autograd

class _Flash(torch.autograd.Function):
    """``(out, natural lse)`` over ``(b·h, s, d)``, differentiable in both."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bwd_impl):
        if q.is_cuda:
            out, lse2 = flash_fwd_cuda(q, k, v, causal)
        else:
            out, lse2 = flash_fwd_plain(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse2)
        ctx.causal, ctx.bwd_impl = causal, bwd_impl
        ctx.set_materialize_grads(False)
        return out, lse2 * (1.0 / LOG2_E)

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse2 = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        # the cotangent's layout is autograd's choice, not the caller's
        do = do.contiguous()
        # delta_i = Σ_d do·o; an lse cotangent enters as a per-row shift
        # (∂lse/∂s = p), so every backward kernel takes it unchanged
        delta = (do.float() * out.float()).sum(dim=-1)
        if dlse is not None:
            delta = delta - dlse.float()
        args = (q, k, v, do, lse2, delta.contiguous(), ctx.causal)
        if ctx.bwd_impl == "fused":
            grads = flash_bwd_fused_cuda(*args) if q.is_cuda else flash_bwd_fused_plain(*args)
        elif q.is_cuda:
            grads = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
        else:
            grads = flash_bwd_split_plain(*args)
        return (*grads, None, None)


def _flat(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.reshape(b * h, s, d).contiguous()


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, block_q: Optional[int] = None,
                        block_k: Optional[int] = None, block_q_bwd: Optional[int] = None,
                        block_k_bwd: Optional[int] = None, interpret: Optional[bool] = None,
                        bwd_impl: Optional[str] = None):
    """:func:`flash_attention` that also returns the per-row natural
    logsumexp ``(b, h, sq)`` f32 — differentiable in both outputs."""
    del interpret  # the TPU kernel's interpreter switch; nothing to select here
    _blocks, _bwd_blocks, bwd_impl = _resolve_flash_config(
        q, k, causal, block_q, block_k, block_q_bwd, block_k_bwd, bwd_impl)
    b, h, sq, d = q.shape
    out, lse = _Flash.apply(_flat(q), _flat(k), _flat(v), causal, bwd_impl)
    return out.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None, block_q_bwd: Optional[int] = None,
                    block_k_bwd: Optional[int] = None, interpret: Optional[bool] = None,
                    bwd_impl: Optional[str] = None) -> torch.Tensor:
    """Differentiable flash attention over (batch, heads, seq, head_dim).

    Blocks default to ``flash_block_choice``/``flash_bwd_block_choice`` and a
    shape no candidate divides raises; explicit blocks must divide exactly.
    ``causal`` requires ``sq == sk``. ``bwd_impl``: "fused" (K5) or "split"
    (K6a + K6b); ``None`` picks "fused" unless the TPU kernel's dq-partials
    buffer would pass :data:`FUSED_BWD_PARTIALS_CAP`.
    """
    out, _lse = flash_attention_lse(
        q, k, v, causal=causal, block_q=block_q, block_k=block_k,
        block_q_bwd=block_q_bwd, block_k_bwd=block_k_bwd, interpret=interpret,
        bwd_impl=bwd_impl)
    return out


def auto_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True) -> torch.Tensor:
    """Model-facing attention.

    On a CUDA tensor: the flash kernels at any length (a causal ``sq != sk``
    raises, as the kernels do). With a flash blocking the backward follows
    :func:`flash_attention`'s ``bwd_impl`` rule; without one it is the fused
    K5, whose dQ buffer does not grow with the key blocks.

    On a CPU tensor: the flash plain versions when the shape has a flash
    blocking, the blockwise scan otherwise — the JAX selector's rule for
    shapes its kernel cannot block."""
    sq, sk = q.shape[2], k.shape[2]
    blocks = flash_block_choice(sq, sk)
    if blocks is not None and (not causal or sq == sk):
        bq, bk = blocks
        return flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    if q.is_cuda:
        if causal and sq != sk:
            raise ValueError(f"causal flash attention requires sq == sk, got {sq} != {sk}")
        b, h, _, d = q.shape
        out, _lse = _Flash.apply(_flat(q), _flat(k), _flat(v), causal, "fused")
        return out.reshape(b, h, sq, d)
    acc, _m, l = blockwise_attention(q, k, v, causal=causal)
    return finalize_attention(acc, l).to(q.dtype)
