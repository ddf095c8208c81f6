"""Decoder-only Transformer LM (counterpart of the JAX ``models/transformer.py``,
training path).

- **Attention is injectable**: ``attn_fn(q, k, v)`` over ``(b, h, s, hd)``
  defaults to :func:`~distributed_ml_pytorch_tpu_torch.ops.attention.auto_attention`
  (causal): the flash kernels on the card, their plain versions on the CPU.
- **Positions are an input** (global positions, ``(b, s)`` or ``(1, s)``), for
  the learned table and for RoPE alike.
- Pre-LN blocks with a tanh-GELU MLP. ``dtype`` threads through every dense
  layer, embedding and LayerNorm as the flax modules' ``dtype`` does: the
  parameters stay float32 (master copies) and are cast to ``dtype`` where they
  are used, so activations are ``dtype`` and the rounding points are the JAX
  model's (explicit casts, no autocast).

Parity details with flax: LayerNorm epsilon 1e-6, statistics and affine in
float32, output cast to ``dtype``; ``nn.gelu`` is the tanh approximation; an
``Embed`` casts the table to ``dtype`` before the lookup. Modules are named as
the flax ones (``tok_embed``, ``block_0.attn.q``, ``block_0.LayerNorm_0``,
``Dense_0`` …), so ``utils/interop.py`` maps parameters by name.

Weights are drawn from a seeded ``torch.Generator`` on the host, with flax's
default distributions: dense kernels lecun-normal (truncated normal, std
sqrt(1/fan_in)/0.8796, cut at two std), embeddings normal with std
1/sqrt(d_model), biases 0, LayerNorm scale 1. The bits are not flax's;
parity tests carry weights across instead.

Decoding (``decode=True``): flax's mutable ``"cache"`` collection becomes an
explicit nested dict passed in and returned, ``logits, cache = model(tokens,
positions, cache=cache)``, under the flax names (``block_i`` → ``attn`` →
``cached_k``, ``cached_v``, ``cursor``, and with ``decode_block`` also
``ring_k``, ``ring_v``, ``ring_base``, with ``kv_quant`` also ``scale_k``,
``scale_v``; ``models/generate.init_cache`` allocates it). The cache's
tensors are updated in place (the K/V writes land in the caller's buffers);
``cursor`` and ``ring_base`` come back as new tensors. They are int32 scalars
(one position for the batch) or ``(B,)`` vectors (one per row, as the slot
pool keeps them). The single-token step of the blocked path is
``ops.decode_attention.decode_attention_step`` (K8); prefill and the plain
path's steps are dense masked attention on ``torch.matmul``, as the JAX
model leaves them to XLA.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distributed_ml_pytorch_tpu_torch.device import resolve_device
from distributed_ml_pytorch_tpu_torch.ops.attention import auto_attention
from distributed_ml_pytorch_tpu_torch.ops.decode_attention import decode_attention_step

LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


def default_attn_fn(q, k, v):
    """Causal attention over the full sequence (see module docstring)."""
    return auto_attention(q, k, v, causal=True)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding for one projection ``(b, h, s, hd)`` by the
    tokens' global ``positions`` ``(b, s)`` or ``(1, s)``: split halves (not
    interleaved pairs) rotated in float32, cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    if 2 * half != x.shape[-1]:
        raise ValueError(f"rope needs an even head_dim, got {x.shape[-1]}")
    freqs = torch.pow(base, -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (b, s, half)
    cos = torch.cos(angles)[:, None]  # (b, 1, s, half): broadcast over heads
    sin = torch.sin(angles)[:, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def quantize_kv(x: torch.Tensor):
    """Per-key symmetric int8 quantization of a K or V block ``(..., d)``:
    ``(int8 values, f32 scale (...,))`` with ``x ≈ int8 * scale``; the scale is
    the absmax over the head dim / 127, floored at 1e-8, and values round half
    to even (as ``jnp.round``)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _row_positions(cursor: torch.Tensor, b: int) -> torch.Tensor:
    """A scalar or ``(b,)`` cursor as ``(b,)`` int64 positions."""
    return cursor.long().expand(b) if cursor.dim() == 0 else cursor.long()


def write_rows(buf: torch.Tensor, val: torch.Tensor, start: torch.Tensor) -> None:
    """``buf[i, :, start[i]:start[i] + s] = val[i]`` for every row ``i``, in
    place: ``buf`` is ``(b, h, C[, d])``, ``val`` ``(b, h, s[, d])`` and
    ``start`` ``(b,)`` int64 (the per-row ``dynamic_update_slice``)."""
    b, s = val.shape[0], val.shape[2]
    pos = start[:, None] + torch.arange(s, device=buf.device)
    rows = torch.arange(b, device=buf.device)[:, None]
    buf[rows, :, pos] = val.transpose(1, 2).to(buf.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: float32 parameters cast to ``dtype`` at
    use; the product and its output in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype=torch.float32):
        super().__init__(d_in, d_out, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Embed(nn.Embedding):
    """flax ``nn.Embed(dtype=...)``: the table cast to ``dtype``, then gathered."""

    def __init__(self, num: int, features: int, dtype=torch.float32):
        super().__init__(num, features)
        self.dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight.to(self.dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: epsilon 1e-6, statistics and affine
    in float32, output cast to ``dtype``."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__(features, eps=LN_EPS)
        self.dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class MultiHeadAttention(nn.Module):
    """Causal multi-head attention; q, k, v and o are bias-free dense layers
    (or one ``qkv`` layer under ``fused_qkv``).

    With ``decode=True`` it keeps a K/V cache (module docstring): each call
    appends the new keys/values at the cursor and attends the query block
    over everything written so far. ``decode_block > 0`` is the ring-buffered
    path: single-token steps write a ``(b, h, decode_block, d)`` ring instead
    of the big cache and the caller merges full rings
    (``models/generate.merge_ring_caches``); ``kv_quant`` keeps the big cache
    in int8 with per-key f32 scales and needs ``decode_block > 0``."""

    def __init__(self, d_model: int, n_heads: int, dtype=torch.float32,
                 attn_fn: Optional[Callable] = None, rope: bool = False,
                 fused_qkv: bool = False, decode: bool = False, cache_size: int = 0,
                 decode_block: int = 0, kv_quant: bool = False):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} must divide by n_heads {n_heads}")
        self.d_model, self.n_heads, self.dtype = d_model, n_heads, dtype
        self.attn_fn, self.rope, self.fused_qkv = attn_fn, rope, fused_qkv
        self.decode, self.cache_size = decode, cache_size
        self.decode_block, self.kv_quant = decode_block, kv_quant
        if fused_qkv:
            self.qkv = Dense(d_model, 3 * d_model, bias=False, dtype=dtype)
        else:
            self.q = Dense(d_model, d_model, bias=False, dtype=dtype)
            self.k = Dense(d_model, d_model, bias=False, dtype=dtype)
            self.v = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.o = Dense(d_model, d_model, bias=False, dtype=dtype)

    def forward(self, x, positions=None, cache=None):
        """``(b, s, d_model)`` out; with ``decode=True``, ``(out, cache)``."""
        b, s, _ = x.shape
        d, h = self.d_model, self.n_heads

        def split(t):
            return t.reshape(b, s, h, d // h).transpose(1, 2)

        if self.fused_qkv:
            qkv = self.qkv(x)
            q, k, v = (split(qkv[..., i * d:(i + 1) * d]) for i in range(3))
        else:
            q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if self.rope:
            if positions is None:
                raise ValueError("rope=True needs the tokens' global positions")
            q = apply_rope(q, positions)
            k = apply_rope(k, positions)  # cached k (decode) is stored rotated
        if self.decode:
            if self.attn_fn is not None:
                raise ValueError(
                    "decode=True uses cached dense attention and cannot honor an "
                    "injected attn_fn — build the decode model with attn_fn=None "
                    "(models/generate.py does this)")
            out, cache = self._cached_attention(q, k, v, cache)
            return self.o(out.transpose(1, 2).reshape(b, s, d)), cache
        out = (self.attn_fn or default_attn_fn)(q, k, v)  # (b, h, s, hd)
        return self.o(out.transpose(1, 2).reshape(b, s, d))

    def _cached_attention(self, q, k, v, cache):
        if self.cache_size < 1:
            raise ValueError("decode=True needs cache_size > 0")
        if self.kv_quant and self.decode_block <= 0:
            raise ValueError(
                "kv_quant=True requires decode_block > 0 — the int8 cache is "
                "quantized at block-merge time (models/generate.py enables both "
                "together)")
        if cache is None:
            raise ValueError("decode=True needs a cache (models/generate.init_cache)")
        if self.decode_block > 0:
            return self._block_cached_attention(q, k, v, cache)
        b, _, s, hd = q.shape
        ck, cv, cursor = cache["cached_k"], cache["cached_v"], cache["cursor"]
        idx = _row_positions(cursor, b)
        write_rows(ck, k, idx)
        write_rows(cv, v, idx)
        return self._attend_cache(q, ck, cv, idx), dict(cache, cursor=cursor + s)

    def _attend_cache(self, q, ck, cv, idx):
        """Causal attention of the query block (row ``r``'s query ``i`` at
        position ``idx[r] + i``) over the whole stored cache: scores and
        softmax in f32 (bf16 products are exact in f32, as the MXU's
        ``preferred_element_type=f32`` einsum), probabilities rounded to the
        activation dtype for the P·V product."""
        s, hd, C = q.shape[2], q.shape[3], ck.shape[2]
        scores = torch.matmul(q.float(), ck.float().transpose(-1, -2)) / math.sqrt(hd)
        q_pos = idx[:, None] + torch.arange(s, device=idx.device)
        seen = torch.arange(C, device=idx.device)[None, None, :] <= q_pos[:, :, None]
        scores = torch.where(seen[:, None], scores, torch.full((), -math.inf, device=q.device))
        probs = torch.softmax(scores, dim=-1)
        return torch.matmul(probs.to(self.dtype).float(), cv.float()).to(q.dtype)

    def _block_cached_attention(self, q, k, v, cache):
        """Ring-buffered decode (see the class docstring): single-token steps
        attend over the big cache below ``ring_base``, the ring below ``t =
        cursor - ring_base`` and the fresh token (K8), and append K/V to the
        ring. Multi-token (prefill) calls bulk-write the big cache and anchor
        ``ring_base`` at the end of the prompt.

        Under ``kv_quant`` the prefill attends with the exact in-hand K/V and
        writes their quantization; that requires an empty cache (cursor 0):
        rows whose cursor is not 0 come back NaN (the single-prefill
        contract of ``models/generate.init_cache``)."""
        b, _, s, hd = q.shape
        quant = self.kv_quant
        k, v = k.to(self.dtype), v.to(self.dtype)
        ck, cv, cursor = cache["cached_k"], cache["cached_v"], cache["cursor"]
        ring_k, ring_v, ring_base = cache["ring_k"], cache["ring_v"], cache["ring_base"]
        scale_k, scale_v = cache.get("scale_k"), cache.get("scale_v")
        if s != 1:  # prefill: bulk write straight to the big cache
            idx = _row_positions(cursor, b)
            if quant:
                k8, ks = quantize_kv(k)
                v8, vs = quantize_kv(v)
                write_rows(ck, k8, idx)
                write_rows(cv, v8, idx)
                write_rows(scale_k, ks, idx)
                write_rows(scale_v, vs, idx)
            else:
                write_rows(ck, k, idx)
                write_rows(cv, v, idx)
            new = dict(cache, cursor=cursor + s, ring_base=cursor + s)
            if not quant:
                # attention over what is now in the big cache: the plain
                # path's prefill math
                return self._attend_cache(q, ck, cv, idx), new
            s_loc = torch.matmul(q.float(), k.float().transpose(-1, -2))
            causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
            s_loc = torch.where(causal, s_loc, torch.full((), -math.inf, device=q.device))
            probs = torch.softmax(s_loc / math.sqrt(hd), dim=-1)
            out = torch.matmul(probs.to(self.dtype).float(), v.float())
            out = torch.where((idx == 0)[:, None, None, None], out,
                              torch.full((), math.nan, device=q.device))
            return out.to(q.dtype), new
        t = cursor - ring_base  # slot in the current block, 0..T-1
        out = decode_attention_step(q, k, v, ck, cv, ring_k, ring_v, t, ring_base,
                                    scale_k, scale_v)
        slot = _row_positions(t, b)
        rows = torch.arange(b, device=q.device)
        ring_k[rows, :, slot] = k[:, :, 0]
        ring_v[rows, :, slot] = v[:, :, 0]
        return out, dict(cache, cursor=cursor + 1)


class Block(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + Dense_1(gelu(Dense_0(LN(x))))."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dtype=torch.float32,
                 attn_fn: Optional[Callable] = None, rope: bool = False,
                 fused_qkv: bool = False, decode: bool = False, cache_size: int = 0,
                 decode_block: int = 0, kv_quant: bool = False):
        super().__init__()
        self.decode = decode
        self.LayerNorm_0 = LayerNorm(d_model, dtype)
        self.attn = MultiHeadAttention(d_model, n_heads, dtype, attn_fn, rope=rope,
                                       fused_qkv=fused_qkv, decode=decode,
                                       cache_size=cache_size, decode_block=decode_block,
                                       kv_quant=kv_quant)
        self.LayerNorm_1 = LayerNorm(d_model, dtype)
        self.Dense_0 = Dense(d_model, d_ff, dtype=dtype)
        self.Dense_1 = Dense(d_ff, d_model, dtype=dtype)

    def forward(self, x, positions=None, cache=None):
        """``x`` out; with ``decode=True``, ``(x, cache)`` (``cache`` is this
        block's ``{"attn": {...}}``)."""
        if self.decode:
            a, attn_cache = self.attn(self.LayerNorm_0(x), positions, cache["attn"])
            cache = {"attn": attn_cache}
        else:
            a = self.attn(self.LayerNorm_0(x), positions)
        x = x + a
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        x = x + self.Dense_1(h)
        return (x, cache) if self.decode else x


class TransformerLM(nn.Module):
    """Causal LM over token ids; ``positions`` carries global positions.

    ``head=False`` makes ``forward`` return the post-LayerNorm hidden states
    instead of logits (:meth:`hidden` does so regardless), the entry of the
    losses that apply ``lm_head`` themselves. ``remat=True`` recomputes each
    block in the backward (``torch.utils.checkpoint``; not under decode).

    ``decode=True`` (with ``cache_size``, ``decode_block``, ``kv_quant``)
    makes ``forward(tokens, positions, cache)`` return ``(logits, cache)``
    (module docstring). ``device="meta"`` builds the structure without
    drawing or allocating weights, for a caller that assigns its own
    (``models/generate._decode_model``).
    """

    def __init__(self, vocab_size: int = 32000, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 6, d_ff: int = 2048, max_len: int = 131072,
                 dtype=torch.float32, attn_fn: Optional[Callable] = None,
                 decode: bool = False, cache_size: int = 0, decode_block: int = 0,
                 kv_quant: bool = False, fused_qkv: bool = False, remat: bool = False,
                 pos_encoding: str = "learned", head: bool = True,
                 seed: int = 0, device="cuda"):
        super().__init__()
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"unknown pos_encoding {pos_encoding!r}")
        meta = torch.device(device).type == "meta"
        dev = None if meta else resolve_device(device)
        self.vocab_size, self.d_model, self.n_heads = vocab_size, d_model, n_heads
        self.n_layers, self.d_ff, self.max_len, self.dtype = n_layers, d_ff, max_len, dtype
        self.remat, self.pos_encoding, self.head = remat, pos_encoding, head
        self.fused_qkv, self.decode, self.cache_size = fused_qkv, decode, cache_size
        self.decode_block, self.kv_quant = decode_block, kv_quant
        with torch.device("meta") if meta else contextlib.nullcontext():
            self.tok_embed = Embed(vocab_size, d_model, dtype)
            if pos_encoding == "learned":
                self.pos_embed = Embed(max_len, d_model, dtype)
            for i in range(n_layers):
                self.add_module(f"block_{i}", Block(
                    d_model, n_heads, d_ff, dtype, attn_fn, rope=pos_encoding == "rope",
                    fused_qkv=fused_qkv, decode=decode, cache_size=cache_size,
                    decode_block=decode_block, kv_quant=kv_quant))
            self.LayerNorm_0 = LayerNorm(d_model, dtype)
            self.lm_head = Dense(d_model, vocab_size, bias=False, dtype=dtype)
        if not meta:
            init_flax_default_(self, seed)
            self.to(dev)

    def config(self) -> dict:
        """The architecture's constructor arguments (no decode, weights or
        device), to build a sibling such as the decode model."""
        return dict(vocab_size=self.vocab_size, d_model=self.d_model, n_heads=self.n_heads,
                    n_layers=self.n_layers, d_ff=self.d_ff, max_len=self.max_len,
                    dtype=self.dtype, fused_qkv=self.fused_qkv, remat=self.remat,
                    pos_encoding=self.pos_encoding, head=self.head)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    def set_attn_fn(self, attn_fn: Optional[Callable]) -> None:
        """Inject ``attn_fn`` into every block (``None``: the default)."""
        for blk in self.blocks():
            blk.attn.attn_fn = attn_fn

    def hidden(self, tokens, positions=None, cache=None):
        """The post-LayerNorm hidden states ``(b, s, d_model)`` in ``dtype``;
        with ``decode=True``, ``(hidden, cache)``."""
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)[None, :]
        x = self.tok_embed(tokens)
        if self.pos_encoding == "learned":
            x = x + self.pos_embed(positions)
        if self.decode:
            if cache is None:
                raise ValueError("decode=True needs a cache (models/generate.init_cache)")
            new_cache = {}
            for i, blk in enumerate(self.blocks()):
                x, new_cache[f"block_{i}"] = blk(x, positions, cache[f"block_{i}"])
            return self.LayerNorm_0(x), new_cache
        for blk in self.blocks():
            if self.remat:
                x = checkpoint(blk, x, positions, use_reentrant=False)
            else:
                x = blk(x, positions)
        return self.LayerNorm_0(x)

    def forward(self, tokens, positions=None, cache=None):
        if self.decode:
            x, cache = self.hidden(tokens, positions, cache)
            return (self.lm_head(x) if self.head else x), cache
        x = self.hidden(tokens, positions)
        return self.lm_head(x) if self.head else x


def init_flax_default_(model: nn.Module, seed: int) -> nn.Module:
    """flax's default initialisation, drawn in module order from a seeded
    host generator (see module docstring)."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Embed):
                w = torch.empty(mod.weight.shape).normal_(
                    0.0, 1.0 / math.sqrt(mod.embedding_dim), generator=g)
                mod.weight.copy_(w)
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model
