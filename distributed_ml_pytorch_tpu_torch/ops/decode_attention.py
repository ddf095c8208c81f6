"""Single-token decode attention (K8) — counterpart of the JAX
``ops/decode_attention.py``.

One decode step's attention for a query ``(B, H, 1, D)`` over three parts:

- the big cache ``(B, H, C, D)`` masked to keys ``< ring_base``, in the
  activation dtype or int8 with per-key ``scale_k``/``scale_v`` ``(B, H, C)``
  f32 (``scale_k`` multiplies the score after the dot, ``scale_v`` the weight
  before the P·V product);
- the ring ``(B, H, T, D)`` masked to slots ``< t``;
- the fresh token ``k_new``/``v_new`` ``(B, H, 1, D)``, always present.

One f32 softmax covers all three; the output is cast once to ``q``'s dtype.
``t`` and ``ring_base`` are per batch row: Python ints, 0-dim tensors or
``(B,)`` integer tensors (the slot pool keeps one per slot).

This is exactly the single-token step of the blocked decode in
``models/transformer.MultiHeadAttention``, which calls
:func:`decode_attention_step` on every such step. On CUDA tensors that is the
kernel of ``csrc/decode_attention.cu`` (any context length; head_dim 16,
32, 64 or 128; float32 or bfloat16 activations; the big cache may be a strided
live-prefix view), one launch whose blocks split each (b, h)'s keys over a
thread-block cluster of :func:`decode_splits` blocks. On CPU tensors it is
:func:`decode_attention_reference`,
the module's own math in the module's op order. There is no other path: a
CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from distributed_ml_pytorch_tpu_torch.ops import _build

#: head dims the CUDA kernel is built for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: blocks the kernel may split one (b, h)'s keys over: the cluster sizes
#: every Hopper card launches (larger ones need a non-portable attribute)
SPLITS = (1, 2, 4, 8)
#: fewest keys of the big cache a split may be given: merging the splits
#: (two cluster barriers, reads of the other blocks' shared memory) costs
#: about one round of device memory, so a split has to save more than one
#: chunk of loads (128 keys a block at bfloat16 head_dim 64)
MIN_KEYS_PER_SPLIT = 256

#: launches of the CUDA kernel (the reference does not count)
launches = 0


def decode_splits(bh: int, C: int, sms: int) -> int:
    """Blocks per (b, h) for ``bh`` (batch x heads) rows over a big cache
    of ``C`` keys on a card of ``sms`` SMs: the largest S of :data:`SPLITS`
    whose grid of ``bh * S`` blocks fits two blocks to an SM and whose splits
    keep at least :data:`MIN_KEYS_PER_SPLIT` keys of C each; 1 where none
    does. A grid past one wave, or a split of few keys, loses more than it
    gains (``chip_smoke.py`` phase 7 times every S at the small batches).
    ``C`` is the length of the big cache as passed: both callers pass a
    live-prefix view (``generate()`` the block's live length, the serving
    pool its longest slot's), so the splits count keys that can be live.
    Shapes only: ``t`` and ``ring_base`` stay on the card, so choosing costs
    no host sync."""
    best = 1
    for s in SPLITS:
        if bh * s <= 2 * sms and C >= s * MIN_KEYS_PER_SPLIT:
            best = s
    return best


def _rows(x, b: int, device) -> torch.Tensor:
    """``t`` / ``ring_base`` as a ``(b,)`` int32 tensor on ``device``."""
    x = torch.as_tensor(x, device=device)
    if x.dim() == 0:
        x = x.expand(b)
    if x.shape != (b,):
        raise ValueError(f"per-row t / ring_base must be a scalar or ({b},), got {tuple(x.shape)}")
    return x.to(torch.int32)


def _probs(q, k_new, big_k, ring_k, t, ring_base, scale_k):
    """The step's f32 softmax over ``[big cache | ring | fresh token]``,
    ``(B, H, 1, C + T + 1)``: scores in f32 (times ``scale_k``), masked to
    keys ``< ring_base`` and slots ``< t``, divided by sqrt(d)."""
    b, _, _, d = q.shape
    C, T = big_k.shape[2], ring_k.shape[2]
    t = _rows(t, b, q.device)
    rb = _rows(ring_base, b, q.device)
    qf = q.float()
    s_big = torch.matmul(qf, big_k.to(q.dtype).float().transpose(-1, -2))
    if scale_k is not None:
        s_big = s_big * scale_k[:, :, None, :]
    neg = torch.full((), -math.inf, device=q.device)
    live = torch.arange(C, device=q.device)[None, :] < rb[:, None]
    s_big = torch.where(live[:, None, None, :], s_big, neg)
    s_ring = torch.matmul(qf, ring_k.float().transpose(-1, -2))
    filled = torch.arange(T, device=q.device)[None, :] < t[:, None]
    s_ring = torch.where(filled[:, None, None, :], s_ring, neg)
    s_self = (qf * k_new.float()).sum(-1, keepdim=True)
    return torch.softmax(torch.cat([s_big, s_ring, s_self], dim=-1) / math.sqrt(d), dim=-1)


def decode_attention_reference(q, k_new, v_new, big_k, big_v, ring_k, ring_v, t,
                               ring_base, scale_k=None, scale_v=None) -> torch.Tensor:
    """The plain version: the blocked decode step's math as the JAX module
    computes it — f32 scores, masks, one softmax over the concatenated parts,
    ``p`` (times ``scale_v``) rounded to the activation dtype before the
    big-cache and ring P·V products, the fresh token's weight kept in f32."""
    dt = q.dtype
    C, T = big_k.shape[2], ring_k.shape[2]
    probs = _probs(q, k_new, big_k, ring_k, t, ring_base, scale_k)
    p_big = probs[..., :C]
    if scale_v is not None:
        p_big = p_big * scale_v[:, :, None, :]
    out = (torch.matmul(p_big.to(dt).float(), big_v.to(dt).float())
           + torch.matmul(probs[..., C:C + T].to(dt).float(), ring_v.float())
           + probs[..., C + T:] * v_new.float())
    return out.to(dt)


def _check_rows_aligned(name: str, x: torch.Tensor, rows: int) -> None:
    """The kernel reads each ``(…, D)`` row with 16-byte loads."""
    if x.stride(-1) != 1:
        raise ValueError(f"decode attention: {name} needs a contiguous last dim, "
                         f"got strides {x.stride()}")
    es = x.element_size()
    if x.data_ptr() % 16 or any(s * es % 16 for s in x.stride()[:rows]):
        raise ValueError(f"decode attention: {name} rows must be 16-byte aligned, "
                         f"got strides {x.stride()} at offset {x.data_ptr() % 16}")


def decode_attention_cuda(q, k_new, v_new, big_k, big_v, ring_k, ring_v, t, ring_base,
                          scale_k=None, scale_v=None, *, splits=None) -> torch.Tensor:
    """Launch K8 on CUDA tensors; returns ``(B, H, 1, D)`` in ``q``'s dtype.
    ``splits`` (one of :data:`SPLITS`) overrides :func:`decode_splits`, so
    that tests can hold every split count to the same inputs."""
    global launches
    b, h, one, d = q.shape
    quant = big_k.dtype == torch.int8
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "big_k": big_k, "big_v": big_v,
               "ring_k": ring_k, "ring_v": ring_v}
    if quant:
        if scale_k is None or scale_v is None:
            raise ValueError("decode attention: an int8 cache needs scale_k and scale_v")
        tensors.update(scale_k=scale_k, scale_v=scale_v)
    elif scale_k is not None or scale_v is not None:
        raise ValueError("decode attention: scales come only with an int8 cache")
    for name, x in tensors.items():
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"decode attention: {name} must be on q's CUDA device")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode attention: the CUDA kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode attention: the CUDA kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if one != 1 or k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError("decode attention: q, k_new and v_new must be (B, H, 1, D)")
    if any(x.dtype != q.dtype for x in (k_new, v_new, ring_k, ring_v)):
        raise TypeError("decode attention: q, k_new, v_new and the ring must share a dtype")
    if big_k.dtype != big_v.dtype or big_k.dtype not in (q.dtype, torch.int8):
        raise TypeError(f"decode attention: the big cache must be {q.dtype} or int8, "
                        f"got {big_k.dtype} / {big_v.dtype}")
    C, T = big_k.shape[2], ring_k.shape[2]
    if big_k.shape != (b, h, C, d) or big_v.shape != big_k.shape:
        raise ValueError(f"decode attention: big cache must be ({b}, {h}, C, {d})")
    if ring_k.shape != (b, h, T, d) or ring_v.shape != ring_k.shape:
        raise ValueError(f"decode attention: ring must be ({b}, {h}, T, {d})")
    if quant:
        for name in ("scale_k", "scale_v"):
            sc = tensors[name]
            if sc.dtype != torch.float32 or sc.shape != (b, h, C):
                raise ValueError(f"decode attention: {name} must be float32 ({b}, {h}, {C})")
    for name in ("k_new", "v_new"):
        _check_rows_aligned(name, tensors[name], 2)
    for name in ("big_k", "big_v", "ring_k", "ring_v"):
        _check_rows_aligned(name, tensors[name], 3)
    if splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = decode_splits(b * h, C, sms)
    elif splits not in SPLITS:
        raise ValueError(f"decode attention: splits must be one of {SPLITS}, got {splits}")
    # read through their row stride: a value every row shares (stride 0)
    # costs no copy kernel
    t = _rows(t, b, q.device)
    rb = _rows(ring_base, b, q.device)
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    ptrs = (ctypes.c_void_p * 12)(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), big_k.data_ptr(),
        big_v.data_ptr(), ring_k.data_ptr(), ring_v.data_ptr(),
        scale_k.data_ptr() if quant else 0, scale_v.data_ptr() if quant else 0,
        t.data_ptr(), rb.data_ptr(), out.data_ptr())
    sk_st = scale_k.stride() if quant else (0, 0, 0)
    sv_st = scale_v.stride() if quant else (0, 0, 0)
    strides = (ctypes.c_longlong * 26)(
        *q.stride()[:2], *k_new.stride()[:2], *v_new.stride()[:2],
        *big_k.stride()[:3], *big_v.stride()[:3], *ring_k.stride()[:3],
        *ring_v.stride()[:3], *sk_st, *sv_st, t.stride(0), rb.stride(0))
    dims = (ctypes.c_int * 8)(b, h, C, T, d, _DTYPE_CODES[q.dtype], int(quant), splits)
    fn = _build.load("decode_attention").dmt_decode_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        code = fn(ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p),
                  ctypes.cast(dims, ctypes.c_void_p), math.sqrt(d), _build.stream_of(q))
    _build.check(code, "decode attention")
    launches += 1
    return out


def decode_attention_step(q, k_new, v_new, big_k, big_v, ring_k, ring_v, t, ring_base,
                          scale_k=None, scale_v=None) -> torch.Tensor:
    """One decode step's attention output ``(B, H, 1, D)`` (see the module
    docstring): the CUDA kernel for tensors on the card, the reference for
    tensors on the CPU."""
    if q.is_cuda:
        return decode_attention_cuda(q, k_new, v_new, big_k, big_v, ring_k, ring_v, t,
                                     ring_base, scale_k, scale_v)
    return decode_attention_reference(q, k_new, v_new, big_k, big_v, ring_k, ring_v, t,
                                      ring_base, scale_k, scale_v)


def decode_error_scale(q, k_new, v_new, big_k, big_v, ring_k, ring_v, t, ring_base,
                       scale_k=None, scale_v=None) -> torch.Tensor:
    """The absolute product that bounds the kernel's difference from the
    reference under bfloat16, f32 ``(B, H, 1, D)``: ``P·|V|`` over the three
    parts, with ``P·scale_v·|V8|`` for an int8 cache. Rounding each weight of
    a sum to bfloat16 moves it by at most the unit roundoff times this."""
    C, T = big_k.shape[2], ring_k.shape[2]
    probs = _probs(q, k_new, big_k, ring_k, t, ring_base, scale_k)
    p_big = probs[..., :C]
    if scale_v is not None:
        p_big = p_big * scale_v[:, :, None, :]
    return (torch.matmul(p_big, big_v.float().abs())
            + torch.matmul(probs[..., C:C + T], ring_v.float().abs())
            + probs[..., C + T:] * v_new.float().abs())
