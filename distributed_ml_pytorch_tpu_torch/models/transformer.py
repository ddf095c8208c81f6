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

The decode path (``decode=True``, the KV cache, ``kv_quant``,
``decode_block``) is not ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distributed_ml_pytorch_tpu_torch.device import resolve_device
from distributed_ml_pytorch_tpu_torch.ops.attention import auto_attention

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
    (or one ``qkv`` layer under ``fused_qkv``)."""

    def __init__(self, d_model: int, n_heads: int, dtype=torch.float32,
                 attn_fn: Optional[Callable] = None, rope: bool = False,
                 fused_qkv: bool = False):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} must divide by n_heads {n_heads}")
        self.d_model, self.n_heads = d_model, n_heads
        self.attn_fn, self.rope, self.fused_qkv = attn_fn, rope, fused_qkv
        if fused_qkv:
            self.qkv = Dense(d_model, 3 * d_model, bias=False, dtype=dtype)
        else:
            self.q = Dense(d_model, d_model, bias=False, dtype=dtype)
            self.k = Dense(d_model, d_model, bias=False, dtype=dtype)
            self.v = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.o = Dense(d_model, d_model, bias=False, dtype=dtype)

    def forward(self, x, positions=None):
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
            k = apply_rope(k, positions)
        out = (self.attn_fn or default_attn_fn)(q, k, v)  # (b, h, s, hd)
        return self.o(out.transpose(1, 2).reshape(b, s, d))


class Block(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + Dense_1(gelu(Dense_0(LN(x))))."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dtype=torch.float32,
                 attn_fn: Optional[Callable] = None, rope: bool = False,
                 fused_qkv: bool = False):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d_model, dtype)
        self.attn = MultiHeadAttention(d_model, n_heads, dtype, attn_fn, rope=rope,
                                       fused_qkv=fused_qkv)
        self.LayerNorm_1 = LayerNorm(d_model, dtype)
        self.Dense_0 = Dense(d_model, d_ff, dtype=dtype)
        self.Dense_1 = Dense(d_ff, d_model, dtype=dtype)

    def forward(self, x, positions=None):
        x = x + self.attn(self.LayerNorm_0(x), positions)
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class TransformerLM(nn.Module):
    """Causal LM over token ids; ``positions`` carries global positions.

    ``head=False`` makes ``forward`` return the post-LayerNorm hidden states
    instead of logits (:meth:`hidden` does so regardless), the entry of the
    losses that apply ``lm_head`` themselves. ``remat=True`` recomputes each
    block in the backward (``torch.utils.checkpoint``).
    """

    def __init__(self, vocab_size: int = 32000, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 6, d_ff: int = 2048, max_len: int = 131072,
                 dtype=torch.float32, attn_fn: Optional[Callable] = None,
                 decode: bool = False, cache_size: int = 0, decode_block: int = 0,
                 kv_quant: bool = False, fused_qkv: bool = False, remat: bool = False,
                 pos_encoding: str = "learned", head: bool = True,
                 seed: int = 0, device="cuda"):
        super().__init__()
        if decode or cache_size or decode_block or kv_quant:
            raise NotImplementedError(
                "decode=True, the KV cache (cache_size, decode_block) and kv_quant are "
                "not ported yet: they belong to the serving slice of the port")
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"unknown pos_encoding {pos_encoding!r}")
        dev = resolve_device(device)
        self.vocab_size, self.d_model, self.n_heads = vocab_size, d_model, n_heads
        self.n_layers, self.d_ff, self.dtype = n_layers, d_ff, dtype
        self.remat, self.pos_encoding, self.head = remat, pos_encoding, head
        self.tok_embed = Embed(vocab_size, d_model, dtype)
        if pos_encoding == "learned":
            self.pos_embed = Embed(max_len, d_model, dtype)
        for i in range(n_layers):
            self.add_module(f"block_{i}", Block(
                d_model, n_heads, d_ff, dtype, attn_fn, rope=pos_encoding == "rope",
                fused_qkv=fused_qkv))
        self.LayerNorm_0 = LayerNorm(d_model, dtype)
        self.lm_head = Dense(d_model, vocab_size, bias=False, dtype=dtype)
        init_flax_default_(self, seed)
        self.to(dev)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    def set_attn_fn(self, attn_fn: Optional[Callable]) -> None:
        """Inject ``attn_fn`` into every block (``None``: the default)."""
        for blk in self.blocks():
            blk.attn.attn_fn = attn_fn

    def hidden(self, tokens, positions=None):
        """The post-LayerNorm hidden states ``(b, s, d_model)`` in ``dtype``."""
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)[None, :]
        x = self.tok_embed(tokens)
        if self.pos_encoding == "learned":
            x = x + self.pos_embed(positions)
        for blk in self.blocks():
            if self.remat:
                x = checkpoint(blk, x, positions, use_reentrant=False)
            else:
                x = blk(x, positions)
        return self.LayerNorm_0(x)

    def forward(self, tokens, positions=None):
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
