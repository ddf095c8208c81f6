"""Ring attention: sequence parallelism over a mesh axis (counterpart of the
JAX ``parallel/ring.py``).

The sequence is sharded over ``axis``: each rank holds a ``(batch, heads,
S/p, dim)`` chunk of Q, K and V. Attention over the whole sequence takes
``p`` ring steps: every rank attends its queries to the K/V chunk it holds,
folds the result into a running softmax state and passes the chunk one hop
on (``DeviceMesh.permute``, rank ``j`` to ``j + 1``). No rank ever holds
more than one chunk of K/V beside its own.

Two per-chunk implementations share the ring:

- ``flash``: each held chunk goes through the flash forward, K4 on the card
  (:func:`~distributed_ml_pytorch_tpu_torch.ops.attention.flash_fwd_cuda`),
  yielding the chunk's output and its per-row logsumexp; chunks fold by
  logsumexp renormalisation (``o <- o·e^(lse-lse') + o_i·e^(lse_i-lse')``,
  JAX ``ring.py:124-132``);
- ``blockwise``: the online-softmax scan of ``ops.attention.
  blockwise_attention`` with global query/key offsets, its ``(m, l, acc)``
  states merged (the JAX non-TPU path).

``impl=None`` picks flash on a CUDA tensor and blockwise on a CPU tensor
(JAX ``ring.py:182-185`` picks flash on its accelerator). On a CUDA tensor
the ring always runs the kernels: they tile by 64 and take any chunk
length, and a chunk that no flash blocking divides takes the fused K5
backward, as ``auto_attention`` does; ``impl="blockwise"`` there raises.

Causality across chunks: rank ``i``'s queries sit at ``[i·S/p, (i+1)·S/p)``
and the chunk of rank ``j`` holds keys at ``[j·S/p, ...)``. A held chunk is
the diagonal one (causal attention), a past one (plain attention) or a
future one, which launches nothing and contributes the ``NEG_INF`` floor.

**The backward is written by hand.** Ranks skip different numbers of
chunks, so autograd's own order of the reverse permutes would differ from
rank to rank. The ring is one ``torch.autograd.Function``; its backward
runs the ring again: each rank's K/V chunk travels with its dK/dV
accumulators (float32), every holder adds its contribution, and a last hop
returns them to their owner; every hop has its own tag. Each chunk's
contribution is the flash backward (K5, or K6a + K6b by the size rule) fed
the ring's merged logsumexp and ``delta = rowsum(dO·O)`` of the merged
output: the merge's lse cotangent, folded into each chunk's ``delta`` as
``_Flash.backward`` folds it (``delta_i = w_i·delta`` with the chunk's
``dO_i = w_i·dO`` and ``w_i = e^(lse_i-lse)``), reduces to exactly these
inputs, because ``w_i·P_i`` is the globally normalised ``P``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from distributed_ml_pytorch_tpu_torch.ops import attention as _att
from distributed_ml_pytorch_tpu_torch.ops.attention import (
    LOG2_E,
    NEG_INF,
    blockwise_attention,
    finalize_attention,
    flash_block_choice,
    init_softmax_state,
)
from distributed_ml_pytorch_tpu_torch.runtime.mesh import DeviceMesh

#: the chunk a rank holds, relative to its queries
DIAG, PAST, FUTURE = "diag", "past", "future"


def chunk_case(idx: int, src: int, causal: bool) -> str:
    """How rank ``idx``'s queries see the chunk of rank ``src``."""
    if not causal or src < idx:
        return PAST
    return DIAG if src == idx else FUTURE


def _merge_softmax_states(m1, l1, a1, m2, l2, a2):
    """Merge two online-softmax partial states (associative)."""
    m = torch.maximum(m1, m2)
    c1 = torch.exp(torch.clamp(m1 - m, min=NEG_INF))
    c2 = torch.exp(torch.clamp(m2 - m, min=NEG_INF))
    return m, l1 * c1 + l2 * c2, a1 * c1 + a2 * c2


def _merge_lse(o, lse, o_i, lse_i):
    """Fold a chunk's ``(o_i, lse_i)`` into ``(o, lse)`` (natural log, f32)."""
    lse_new = torch.logaddexp(lse, lse_i)
    w = torch.exp(lse - lse_new)[..., None]
    w_i = torch.exp(lse_i - lse_new)[..., None]
    return o * w + o_i * w_i, lse_new


def _flat(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.reshape(b * h, s, d).contiguous()


def _flash_chunk_fwd(q, k, v, causal: bool):
    """One chunk through the flash forward (K4 on a CUDA tensor, its plain
    version on the CPU): ``(o f32 (b, h, s, d), natural lse (b, h, s))``."""
    b, h, s, d = q.shape
    fwd = _att.flash_fwd_cuda if q.is_cuda else _att.flash_fwd_plain
    o, lse2 = fwd(_flat(q), _flat(k), _flat(v), causal)
    return o.reshape(b, h, s, d).float(), (lse2 * (1.0 / LOG2_E)).reshape(b, h, s)


def _bwd_impl(q, k) -> str:
    """The flash backward a chunk takes: ``ops.attention``'s size rule when a
    flash blocking divides the chunk, else the fused K5 (CUDA only: the
    ring's entry points refuse such a chunk on the CPU)."""
    if flash_block_choice(q.shape[2], k.shape[2]) is None:
        return "fused"
    return _att._resolve_flash_config(q, k, False, None, None, None, None, None)[2]


def _flash_chunk_bwd(q, k, v, do, lse2, delta, causal: bool):
    """One chunk's ``(dq, dk, dv)`` from the flash backward with the ring's
    merged base-2 lse and delta: K5 or K6a + K6b on a CUDA tensor (the
    ``bwd_impl`` size rule of ``ops.attention``; K5 for a chunk no flash
    blocking divides), the plain versions on the CPU."""
    b, h, s, d = q.shape
    bwd_impl = _bwd_impl(q, k)
    args = (_flat(q), _flat(k), _flat(v), _flat(do), lse2, delta, causal)
    if q.is_cuda:
        grads = (_att.flash_bwd_fused_cuda(*args) if bwd_impl == "fused" else
                 (_att.flash_bwd_dq_cuda(*args), *_att.flash_bwd_dkv_cuda(*args)))
    elif bwd_impl == "fused":
        grads = _att.flash_bwd_fused_plain(*args)
    else:
        grads = _att.flash_bwd_split_plain(*args)
    return tuple(g.reshape(b, h, s, d).float() for g in grads)


def _blockwise_chunk_bwd(q, k, v, do, lse, delta, case: str):
    """One chunk's ``(dq, dk, dv)`` in plain PyTorch (the blockwise impl):
    the globally normalised ``P = e^(S-lse)`` of the chunk, masked on the
    diagonal, in float32."""
    d = q.shape[-1]
    scale = d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    if case == DIAG:
        n = s.shape[-1]
        p = p * torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dq, dk, dv


class _Ring(torch.autograd.Function):
    """The whole ring, forward and backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh: DeviceMesh, axis: str, causal: bool, impl: str,
                block_k: int):
        p = mesh.axis_size(axis)
        idx = mesh.axis_index(axis)
        ring = [(j, (j + 1) % p) for j in range(p)]
        s_local = q.shape[2]
        k_cur, v_cur = k, v
        if impl == "flash":
            o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            lse = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
        else:
            m, l, acc = init_softmax_state(q)
        for step in range(p):
            src = (idx - step) % p
            case = chunk_case(idx, src, causal)
            if impl == "flash":
                if case != FUTURE:
                    o_i, lse_i = _flash_chunk_fwd(q, k_cur, v_cur, case == DIAG)
                    o, lse = _merge_lse(o, lse, o_i, lse_i)
            else:
                a_i, m_i, l_i = blockwise_attention(
                    q, k_cur, v_cur, causal=causal, block_k=block_k,
                    q_offset=idx * s_local, k_offset=src * s_local)
                m, l, acc = _merge_softmax_states(m, l, acc, m_i, l_i, a_i)
            if step < p - 1:
                k_cur = mesh.permute(k_cur, ring, axis, tag=2 * step)
                v_cur = mesh.permute(v_cur, ring, axis, tag=2 * step + 1)
        if impl != "flash":
            o = finalize_attention(acc, l)
            lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axis, ctx.causal, ctx.impl = mesh, axis, causal, impl
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, impl = ctx.mesh, ctx.axis, ctx.causal, ctx.impl
        p = mesh.axis_size(axis)
        idx = mesh.axis_index(axis)
        ring = [(j, (j + 1) % p) for j in range(p)]
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        b, h, s, d = q.shape
        lse2 = (lse * LOG2_E).reshape(b * h, s).contiguous()
        delta_flat = delta.reshape(b * h, s).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        tag = 0
        for step in range(p):
            src = (idx - step) % p
            case = chunk_case(idx, src, causal)
            if case != FUTURE:
                if impl == "flash":
                    g = _flash_chunk_bwd(q, k_cur, v_cur, do, lse2, delta_flat, case == DIAG)
                else:
                    g = _blockwise_chunk_bwd(q, k_cur, v_cur, do, lse, delta, case)
                dq += g[0]
                dk_cur += g[1]
                dv_cur += g[2]
            # the chunk moves on with its accumulators; after the last step
            # they go home to their owner, rank (idx + 1) mod p's chunk
            if step < p - 1:
                k_cur = mesh.permute(k_cur, ring, axis, tag=tag)
                v_cur = mesh.permute(v_cur, ring, axis, tag=tag + 1)
                tag += 2
            if p > 1:
                dk_cur = mesh.permute(dk_cur, ring, axis, tag=tag)
                dv_cur = mesh.permute(dv_cur, ring, axis, tag=tag + 1)
                tag += 2
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None, None)


def _pick_impl(q, k, impl: Optional[str]) -> str:
    if impl is None:
        return "flash" if q.is_cuda else "blockwise"
    if impl not in ("flash", "blockwise"):
        raise ValueError(f"impl must be 'flash', 'blockwise' or None, got {impl!r}")
    if impl == "blockwise" and q.is_cuda:
        raise ValueError("the blockwise ring is plain PyTorch: on a CUDA tensor the ring "
                         "runs the flash kernels (impl='flash' or None)")
    if impl == "flash" and not q.is_cuda:  # a chunk no flash blocking divides raises here
        _att._resolve_flash_config(q, k, False, None, None, None, None, None)
    return impl


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         mesh: DeviceMesh, axis: str = "seq",
                         causal: bool = False) -> torch.Tensor:
    """Ring attention whose per-chunk compute is the flash kernel pair
    (:func:`ring_attention` with ``impl="flash"``)."""
    return _Ring.apply(q, k, v, mesh, axis, causal, _pick_impl(q, k, "flash"), 0)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: DeviceMesh, axis: str = "seq", causal: bool = False,
                   block_k: int = 512, impl: Optional[str] = None) -> torch.Tensor:
    """Attention over a sequence sharded on ``mesh``'s ``axis``: ``q``,
    ``k``, ``v`` are this rank's ``(batch, heads, S/p, dim)`` chunks (the
    JAX ``shard_map`` body's view); returns the local output chunk.
    ``impl``: ``"flash"``, ``"blockwise"`` or ``None`` (see the module
    docstring); ``block_k`` is the blockwise impl's key block."""
    impl = _pick_impl(q, k, impl)
    return _Ring.apply(q, k, v, mesh, axis, causal, impl, int(block_k))


def make_ring_attention(mesh: DeviceMesh, axis: str = "seq", *, causal: bool = False,
                        block_k: int = 512, impl: Optional[str] = None) -> Callable:
    """``fn(q, k, v)`` over global ``(batch, heads, seq, dim)`` tensors:
    each rank takes its contiguous chunk of the sequence, runs the ring and
    returns its output chunk (the JAX function's ``P(None, None, axis,
    None)`` output, as this rank's shard); seq must divide by the axis
    size."""
    local = functools.partial(ring_attention, mesh=mesh, axis=axis, causal=causal,
                              block_k=block_k, impl=impl)

    def fn(q, k, v):
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        if q.shape[2] % n:
            raise ValueError(f"seq {q.shape[2]} does not divide over {n} ranks of {axis!r}")
        c = q.shape[2] // n
        return local(*(t[:, :, i * c:(i + 1) * c].contiguous() for t in (q, k, v)))

    return fn
