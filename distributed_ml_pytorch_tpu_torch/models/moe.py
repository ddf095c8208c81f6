"""Mixture-of-Experts layers for the Transformer LM (counterpart of the JAX
``models/moe.py``): Switch top-1 and GShard top-k routing.

Routing is a pair of dense one-hot products (dispatch and combine) over
stacked expert weights, as in JAX: no data-dependent shapes or control
flow, three ``torch.einsum`` products and the router. Shapes (B batch, S
sequence, D d_model, F d_ff, E experts, C capacity):

- router probabilities ``[B, S, E]``: the router's logits in the activation
  dtype, the softmax in float32, cast back to the activation dtype;
- dispatch ``[B, S, E, C]`` one-hot (a token to its slot in its expert),
  combine ``[B, S, E, C]`` the dispatch times the token's gate;
- expert inputs ``[E, B, C, D]``, the stacked FFN ``w_up [E, D, F]``,
  ``w_down [E, F, D]`` with a tanh GELU, and the combined ``[B, S, D]``.

Capacity is ``max(1, int(capacity_factor · k · S / E))``. Tokens past an
expert's capacity are dropped (they pass through the residual). Queue
positions are int32 counts, never the activation dtype: a bfloat16 cumsum
loses integer exactness past 256. Top-k capacity is rank-major: every
token's first choice takes a slot before any second choice. Ties between
equal probabilities go to the lower expert index, as ``jnp.argmax`` and
``jax.lax.top_k`` break them (a stable descending sort here).

Rounding points are the JAX model's: the expert weights are float32
parameters that the JAX einsums do not cast, so the expert products, the
combine and the layer's output run in float32 even under a bfloat16
activation dtype, and the residual stream after the first MoE layer is
float32 (JAX's type promotion, which torch's ``+`` reproduces).

The Switch load-balance loss of each forward (JAX's ``sow("losses", ...)``)
stays on the layer as ``MoEMLP.load_balance`` (``MoETransformerLM.
load_balance_losses()`` lists them) for an expert-parallel step to read;
the LM losses ignore it, as JAX's ``lm_loss_builder`` does when the
collection is not mutable.

Decoding: the attention caches K/V as ``TransformerLM``'s does; the MoE FFN
needs no cache. A single-token step has a capacity of at least one slot
per expert, so decode never drops a token, and decode equals the full
forward only where that forward dropped none (JAX ``moe.py:229-236``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    MultiHeadAttention,
    TransformerLM,
    lecun_normal,
)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def switch_route(probs: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routing with per-expert capacity: ``(dispatch, combine)``, each
    ``[B, S, E, C]`` in ``probs.dtype``. ``combine`` carries the router
    probability, so the gradient reaches the router."""
    e = probs.shape[-1]
    onehot = _one_hot(torch.argmax(probs, dim=-1), e, torch.int32)      # [B,S,E]
    # each token's position in its expert's queue: an exclusive cumsum
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    kept = ((pos < capacity) & (onehot > 0)).to(probs.dtype)
    slot = _one_hot((pos * onehot).sum(-1), capacity, probs.dtype)      # [B,S,C]
    dispatch = kept[..., None] * slot[:, :, None, :]
    gate = torch.sum(probs * kept, dim=-1)
    return dispatch, dispatch * gate[:, :, None, None]


def topk_route(probs: torch.Tensor, capacity: int, k: int = 2,
               normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard top-k routing with rank-major capacity: the same contract as
    :func:`switch_route`; ``normalize`` rescales the k gates to sum to 1.
    ``k=1, normalize=False`` is :func:`switch_route` exactly."""
    b, s, e = probs.shape
    if not 1 <= k <= e:
        raise ValueError(f"top-k routing needs 1 <= k <= n_experts, got k={k}, e={e}")
    # a stable descending sort: equal probabilities keep the lower index first
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]                            # [B,S,K]
    oh = _one_hot(idx, e, torch.int32).movedim(2, 1).reshape(b, k * s, e)
    # the queue runs over the rank-major (K·S) axis: rank 0 first
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh
    kept = ((pos < capacity) & (oh > 0)).to(probs.dtype)
    slot = _one_hot((pos * oh).sum(-1), capacity, probs.dtype)          # [B,K*S,C]
    dispatch_k = (kept[..., None] * slot[:, :, None, :]).reshape(b, k, s, e, capacity)
    gate_ks = gates.movedim(2, 1)                                        # [B,K,S]
    if normalize:
        gate_ks = gate_ks / torch.clamp(gate_ks.sum(dim=1, keepdim=True), min=1e-9)
    combine = torch.sum(dispatch_k * gate_ks[..., None, None], dim=1)
    return torch.sum(dispatch_k, dim=1), combine


def load_balance_loss(probs: torch.Tensor) -> torch.Tensor:
    """The Switch auxiliary loss: E · Σ_e (fraction argmax-routed to e) ·
    (mean probability of e), the fraction taken before capacity. Means and
    the sum accumulate in float32 and round to ``probs.dtype``, as
    ``jnp.mean``/``jnp.sum`` do."""
    e = probs.shape[-1]
    onehot = _one_hot(torch.argmax(probs, dim=-1), e, probs.dtype)
    frac_tokens = onehot.mean(dim=(0, 1), dtype=torch.float32).to(probs.dtype)
    frac_probs = probs.mean(dim=(0, 1), dtype=torch.float32).to(probs.dtype)
    return e * torch.sum(frac_tokens * frac_probs, dtype=torch.float32).to(probs.dtype)


class MoEMLP(nn.Module):
    """Switch FFN: a router over ``n_experts`` stacked expert MLPs (top-1,
    or GShard top-k with ``router_top_k >= 2``). ``w_up``, ``b_up``,
    ``w_down`` and ``b_down`` lead with the expert axis, as in JAX."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int = 4,
                 capacity_factor: float = 2.0, dtype=torch.float32, router_top_k: int = 1):
        super().__init__()
        self.d_model, self.d_ff, self.n_experts = d_model, d_ff, n_experts
        self.capacity_factor, self.router_top_k, self.dtype = capacity_factor, router_top_k, dtype
        self.router = Dense(d_model, n_experts, bias=False, dtype=dtype)
        self.w_up = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.b_up = nn.Parameter(torch.zeros(n_experts, d_ff))
        self.w_down = nn.Parameter(torch.empty(n_experts, d_ff, d_model))
        self.b_down = nn.Parameter(torch.zeros(n_experts, d_model))
        #: the last forward's load-balance loss (JAX's sown ``losses``)
        self.load_balance: Optional[torch.Tensor] = None

    def flax_init_(self, g: torch.Generator) -> None:
        """flax's ``lecun_normal(batch_axis=(0,))`` kernels, zero biases."""
        self.w_up.copy_(lecun_normal(self.w_up.shape, self.d_model, g))
        self.w_down.copy_(lecun_normal(self.w_down.shape, self.d_ff, g))
        self.b_up.zero_()
        self.b_down.zero_()

    def capacity(self, seq: int) -> int:
        """Slots an expert has for a sequence of ``seq`` tokens (a top-k
        router emits k assignments a token, so k·S/E are provisioned)."""
        return max(1, int(self.capacity_factor * self.router_top_k * seq / self.n_experts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cap = self.capacity(x.shape[1])
        probs = torch.softmax(self.router(x).float(), dim=-1).to(x.dtype)
        if self.router_top_k == 1:
            dispatch, combine = switch_route(probs, cap)
        else:
            dispatch, combine = topk_route(probs, cap, k=self.router_top_k)
        self.load_balance = load_balance_loss(probs)
        # the expert products promote to the parameters' float32, as JAX's
        # einsums of an activation-dtype input with float32 weights do
        pt = torch.promote_types(x.dtype, self.w_up.dtype)
        xin = torch.einsum("bsec,bsd->ebcd", dispatch, x).to(pt)               # dispatch
        h = torch.einsum("ebcd,edf->ebcf", xin, self.w_up) + self.b_up[:, None, None, :]
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("ebcf,efd->ebcd", h, self.w_down) + self.b_down[:, None, None, :]
        return torch.einsum("bsec,ebcd->bsd", combine.to(pt), out)             # combine


class MoEBlock(nn.Module):
    """Pre-LN block with a Switch-MoE FFN: x + attn(LN(x)), then
    x + moe(LN(x)). With ``decode=True`` it takes and returns its cache
    (``{"attn": {...}}``), as ``models/transformer.Block`` does."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, n_experts: int = 4,
                 capacity_factor: float = 2.0, dtype=torch.float32, router_top_k: int = 1,
                 attn_fn: Optional[Callable] = None, decode: bool = False,
                 cache_size: int = 0, decode_block: int = 0, kv_quant: bool = False,
                 fused_qkv: bool = False):
        super().__init__()
        self.decode = decode
        self.LayerNorm_0 = LayerNorm(d_model, dtype)
        self.attn = MultiHeadAttention(d_model, n_heads, dtype, attn_fn, fused_qkv=fused_qkv,
                                       decode=decode, cache_size=cache_size,
                                       decode_block=decode_block, kv_quant=kv_quant)
        self.LayerNorm_1 = LayerNorm(d_model, dtype)
        self.moe = MoEMLP(d_model, d_ff, n_experts, capacity_factor, dtype,
                          router_top_k=router_top_k)

    def forward(self, x, positions=None, cache=None):
        if self.decode:
            a, attn_cache = self.attn(self.LayerNorm_0(x), positions, cache["attn"])
            cache = {"attn": attn_cache}
        else:
            a = self.attn(self.LayerNorm_0(x), positions)
        x = x + a
        x = x + self.moe(self.LayerNorm_1(x))
        return (x, cache) if self.decode else x


class MoETransformerLM(TransformerLM):
    """Causal LM whose every FFN is a Switch-MoE layer, learned positions.

    ``TransformerLM``'s embedding, LayerNorm, head, remat, decode and
    ``device="meta"`` contracts, with :class:`MoEBlock` blocks. It has no
    detachable head (the JAX model has none): ``head`` is ``None`` and the
    losses take its logits."""

    def __init__(self, vocab_size: int = 32000, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 6, d_ff: int = 2048, n_experts: int = 4,
                 capacity_factor: float = 2.0, max_len: int = 131072, dtype=torch.float32,
                 remat: bool = False, router_top_k: int = 1,
                 attn_fn: Optional[Callable] = None, decode: bool = False,
                 cache_size: int = 0, decode_block: int = 0, kv_quant: bool = False,
                 fused_qkv: bool = False, seed: int = 0, device="cuda"):
        # read by _block while the base class builds the blocks
        self.n_experts, self.capacity_factor = n_experts, capacity_factor
        self.router_top_k = router_top_k
        super().__init__(vocab_size, d_model, n_heads, n_layers, d_ff, max_len, dtype,
                         attn_fn=attn_fn, decode=decode, cache_size=cache_size,
                         decode_block=decode_block, kv_quant=kv_quant, fused_qkv=fused_qkv,
                         remat=remat, pos_encoding="learned", seed=seed, device=device)
        self.head = None

    def _block(self, attn_fn: Optional[Callable]) -> nn.Module:
        return MoEBlock(self.d_model, self.n_heads, self.d_ff, self.n_experts,
                        self.capacity_factor, self.dtype, router_top_k=self.router_top_k,
                        attn_fn=attn_fn, decode=self.decode, cache_size=self.cache_size,
                        decode_block=self.decode_block, kv_quant=self.kv_quant,
                        fused_qkv=self.fused_qkv)

    def config(self) -> dict:
        return dict(vocab_size=self.vocab_size, d_model=self.d_model, n_heads=self.n_heads,
                    n_layers=self.n_layers, d_ff=self.d_ff, n_experts=self.n_experts,
                    capacity_factor=self.capacity_factor, max_len=self.max_len,
                    dtype=self.dtype, remat=self.remat, router_top_k=self.router_top_k,
                    fused_qkv=self.fused_qkv)

    def load_balance_losses(self) -> List[Optional[torch.Tensor]]:
        """Each block's load-balance loss from the last forward."""
        return [blk.moe.load_balance for blk in self.blocks()]

    def forward(self, tokens, positions=None, cache=None):
        if self.decode:
            x, cache = self.hidden(tokens, positions, cache)
            return self.lm_head(x), cache
        return self.lm_head(self.hidden(tokens, positions))
