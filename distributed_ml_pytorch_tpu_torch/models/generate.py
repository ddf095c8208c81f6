"""Autoregressive decoding for the Transformer LM (counterpart of the JAX
``models/generate.py``, without ``generate_tp``).

- **Prefill** runs the whole prompt through the decode model in one call,
  writing every layer's K/V into the cache.
- **Generation** runs single-token steps in a Python loop, with the tokens
  kept on the device (no ``.item()`` per step; the result is fetched once by
  the caller). Two forms: the plain path (one-slot appends to the cache,
  dense masked attention) for short runs and edge shapes, and the
  ring-buffered **blocked** path for runs of :data:`DECODE_BLOCK` steps or
  more: appends go to a small per-layer ring, each block reads a live-prefix
  *view* ``big[:, :, :live]`` of the big cache (the decode-attention kernel
  K8 takes its strides), and the ring is merged into the big cache once per
  block. The int8 cache (``kv_quant``) exists only on the blocked path.
- The decode model is a sibling of the caller's model with its dense and
  embedding weights cast to the activation dtype once (``Dense`` would cast
  the f32 masters at every use; the cast is deterministic, so the bits are
  the same), and under the blocked path the q/k/v projections fused into
  one ``qkv`` (:func:`_fuse_qkv_params`).
- **Sampling** is temperature-controlled categorical (temperature 0 →
  greedy argmax) with optional top-k and nucleus (top-p) truncation, masked
  op for op as the JAX sampler does. ``jax.random``'s bits cannot be
  reproduced in PyTorch: the port takes an integer ``seed`` where JAX takes
  a key, and draws token ``g`` from a ``torch.Generator`` seeded by ``(seed,
  g)`` alone (:func:`step_generator`), so a request's draws never depend on
  what shares its batch. Streams are deterministic given ``(weights,
  prompt, seed)`` on one device; they differ from JAX's in their draws, not
  in their support.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_ml_pytorch_tpu_torch.models.transformer import (
    Dense,
    Embed,
    TransformerLM,
    quantize_kv,
    write_rows,
)

#: ring size of the blocked decode
DECODE_BLOCK = 16

#: longest blocked run, in blocks (the JAX package's compile-size bound of its
#: unrolled outer loop); longer generations take the plain path, as there
MAX_UNROLLED_BLOCKS = 64


# ------------------------------------------------------------------ sampling

def step_generator(seed: int, g: int, device) -> torch.Generator:
    """The generator of token ``g`` of a request with ``seed``: seeded from
    ``(seed, g)`` alone, on ``device``."""
    hi, lo = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(g)]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(hi) << 32) | int(lo))
    return gen


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """One sampling decision over ``[B, vocab]`` logits.

    ``temperature <= 0`` is greedy argmax (k/p ignored). Otherwise optional
    top-k truncation, then optional nucleus truncation of the post-top-k
    distribution (the top token always survives; tokens tying the cut-off
    logit are kept), then a categorical draw at the temperature (Gumbel-max
    with noise from ``generator``, one row of noise per batch row)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("temperature > 0 sampling needs a generator")
    logits = logits / temperature
    vocab = logits.shape[-1]
    neg = torch.full((), torch.finfo(logits.dtype).min, dtype=logits.dtype,
                     device=logits.device)
    top_k = min(int(top_k), vocab) if top_k else 0
    if top_k > 0 or top_p < 1.0:
        # one descending sort serves both filters
        sort_desc = torch.sort(logits, dim=-1, descending=True).values
        if top_k > 0:
            kth = sort_desc[..., top_k - 1:top_k]
            logits = torch.where(logits < kth, neg, logits)
            sort_desc = torch.where(
                torch.arange(vocab, device=logits.device) >= top_k, neg, sort_desc)
        if top_p < 1.0:
            probs = torch.softmax(sort_desc, dim=-1)
            # exclusive cumulative mass: a token is cut iff the mass before
            # it already reaches top_p — the argmax token is never cut
            exceeded = (torch.cumsum(probs, dim=-1) - probs) >= top_p
            exceeded[..., 0] = False
            cut = torch.where(exceeded, torch.full((), float("inf"), device=logits.device),
                              sort_desc)
            thresh = cut.min(dim=-1, keepdim=True).values
            logits = torch.where(logits < thresh, neg, logits)
    noise = _gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits.float() + noise, dim=-1)


def sample_tokens_dynamic(logits: torch.Tensor,
                          generators: Sequence[Optional[torch.Generator]],
                          temperature, top_k, top_p) -> torch.Tensor:
    """Per-row sampling over ``[B, vocab]`` logits with per-row parameters
    (length-``B`` sequences or tensors), the serving engine's face of
    :func:`sample_tokens`: a row equals ``sample_tokens(logits[i:i+1],
    generators[i], temperature[i], top_k[i], top_p[i])``. Rows with
    ``temperature <= 0`` are greedy (their generator may be ``None``)."""
    b, vocab = logits.shape
    dev = logits.device
    t = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    kk = torch.as_tensor(top_k, dtype=torch.int64, device=dev).clamp(0, vocab)
    p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    greedy = torch.argmax(logits, dim=-1)
    neg = torch.full((), torch.finfo(logits.dtype).min, dtype=logits.dtype, device=dev)
    scaled = logits / torch.where(t > 0.0, t, torch.ones((), device=dev)).to(logits.dtype)[:, None]
    sort_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sort_desc.gather(1, (kk - 1).clamp_min(0)[:, None])
    use_k = (kk > 0)[:, None]
    scaled = torch.where(use_k & (scaled < kth), neg, scaled)
    sort_desc = torch.where(use_k & (torch.arange(vocab, device=dev)[None, :] >= kk[:, None]),
                            neg, sort_desc)
    probs = torch.softmax(sort_desc, dim=-1)
    exceeded = (torch.cumsum(probs, dim=-1) - probs) >= p[:, None]
    exceeded[:, 0] = False
    cut = torch.where(exceeded, torch.full((), float("inf"), device=dev), sort_desc)
    thresh = cut.min(dim=-1, keepdim=True).values
    scaled = torch.where((p < 1.0)[:, None] & (scaled < thresh), neg, scaled)
    rows = [i for i, g in enumerate(generators) if g is not None]
    if not rows:
        return greedy
    noise = torch.zeros((b, vocab), device=dev)
    for i in rows:
        noise[i] = _gumbel((1, vocab), generators[i], dev)[0]
    sampled = torch.argmax(scaled.float() + noise, dim=-1)
    return torch.where(t > 0.0, sampled, greedy)


# ------------------------------------------------------------------ the decode model

def _fuse_qkv_params(state: dict) -> dict:
    """Rewrite a ``TransformerLM`` state dict into the ``fused_qkv`` layout:
    every ``….attn.{q,k,v}.weight`` becomes one ``….attn.qkv.weight`` with the
    three ``(d, d)`` kernels stacked on the output axis (``y[..., :d] == q(x)``
    etc.). Anchored on the module name ``attn``; the three weights must be
    2-D and equal-shaped."""
    out = {}
    for name, val in state.items():
        owner, _, leaf = name.rpartition(".")
        parent, _, proj = owner.rpartition(".")
        if (leaf == "weight" and proj in ("q", "k", "v")
                and parent.rsplit(".", 1)[-1] == "attn"):
            if proj != "q":
                continue
            ws = [state[f"{parent}.{n}.weight"] for n in ("q", "k", "v")]
            if not all(w.dim() == 2 and w.shape == ws[0].shape for w in ws):
                raise ValueError(f"{parent} q/k/v weights are not same-shaped 2-D: "
                                 f"{[tuple(w.shape) for w in ws]}")
            out[f"{parent}.qkv.weight"] = torch.cat(ws, dim=0)
        else:
            out[name] = val
    return out


def _decode_model(model: TransformerLM, cache_size: int, decode_block: int = 0,
                  kv_quant: bool = False) -> TransformerLM:
    """The decode sibling of ``model``: ``decode=True`` at ``cache_size``,
    no injected ``attn_fn``, and under ``decode_block`` the fused-qkv layout
    (and ``kv_quant``). It shares no storage with ``model``: its dense and
    embedding weights are ``model``'s cast to the activation dtype once,
    its LayerNorm parameters copies in float32."""
    if kv_quant and not decode_block:
        # an int8 cache only exists under the blocked path; a caller sizing
        # for the halved footprint must not silently get the exact cache
        raise ValueError(
            "kv_quant=True requires decode_block > 0 (int8 quantization happens at "
            "block merges; generate() enables both together)")
    cfg = model.config()
    state = {k: v.detach() for k, v in model.state_dict().items()}
    if decode_block and not cfg["fused_qkv"]:
        state = _fuse_qkv_params(state)
    cfg.update(fused_qkv=cfg["fused_qkv"] or bool(decode_block), remat=False)
    dec = TransformerLM(**cfg, decode=True, cache_size=cache_size, decode_block=decode_block,
                        kv_quant=kv_quant, device="meta")
    cast = {f"{name}.{leaf}" for name, mod in dec.named_modules()
            if isinstance(mod, (Dense, Embed)) for leaf, _ in mod.named_parameters()}
    state = {k: (v.to(cfg["dtype"]) if k in cast else v).clone() for k, v in state.items()}
    dec.load_state_dict(state, assign=True)
    return dec.eval()


def split_cache(cache):
    """Split a decode cache into ``(big, small)``: the per-layer big K/V
    caches and scales vs everything else (rings, cursors, ring_base)."""
    big, small = {}, {}
    for name, val in cache.items():
        if isinstance(val, dict):
            b, s = split_cache(val)
            if b:
                big[name] = b
            if s:
                small[name] = s
        elif name in ("cached_k", "cached_v", "scale_k", "scale_v"):
            big[name] = val
        else:
            small[name] = val
    return big, small


def join_cache(big, small):
    """Inverse of :func:`split_cache`."""
    out = dict(small)
    for name, val in big.items():
        if isinstance(val, dict):
            out[name] = join_cache(val, small.get(name, {}))
        else:
            out[name] = val
    return out


def _check_max_len(model, total: int) -> None:
    """RoPE rotates by position instead of indexing a table, so ``max_len``
    bounds only learned position embeddings."""
    max_len = getattr(model, "max_len", None)
    if (max_len is not None and total > max_len
            and getattr(model, "pos_encoding", "learned") != "rope"):
        raise ValueError(
            f"prompt + max_new_tokens = {total} exceeds the model's max_len {max_len} — "
            "position embeddings would go out of range")


def init_cache(model: TransformerLM, batch: int, cache_size: int, decode_block: int = 0,
               kv_quant: bool = False):
    """Allocate the per-layer K/V cache (zeros, cursor at 0) for ``batch``
    sequences of total length ``cache_size``, on ``model``'s device.

    ``kv_quant=True`` caches carry the single-prefill contract: the first
    multi-token call must happen at cursor 0; a second prefill into a
    non-empty quantized cache returns NaN by design (the quantized prefill
    attends with its exact in-hand K/V and does not read earlier blocks
    back). :func:`generate` always satisfies this, and the slot pool
    (``serving/cache.py``) prefills every admission into a fresh lane."""
    if kv_quant and not decode_block:
        raise ValueError("kv_quant=True requires decode_block > 0")
    dev = next(model.parameters()).device
    hd = model.d_model // model.n_heads
    shape = (batch, model.n_heads, cache_size, hd)
    store = torch.int8 if kv_quant else model.dtype
    cache = {}
    for i in range(model.n_layers):
        attn = {"cached_k": torch.zeros(shape, dtype=store, device=dev),
                "cached_v": torch.zeros(shape, dtype=store, device=dev),
                "cursor": torch.zeros((), dtype=torch.int32, device=dev)}
        if kv_quant:
            attn["scale_k"] = torch.zeros(shape[:3], device=dev)
            attn["scale_v"] = torch.zeros(shape[:3], device=dev)
        if decode_block:
            ring = (batch, model.n_heads, decode_block, hd)
            attn["ring_k"] = torch.zeros(ring, dtype=model.dtype, device=dev)
            attn["ring_v"] = torch.zeros(ring, dtype=model.dtype, device=dev)
            attn["ring_base"] = torch.zeros((), dtype=torch.int32, device=dev)
        cache[f"block_{i}"] = {"attn": attn}
    return cache


def uses_block_decode(model, prompt_len: int, max_new_tokens: int) -> Tuple[bool, int]:
    """Whether :func:`generate` takes the blocked path for this shape, and
    the padded cache allocation it would use. The step loop is padded to a
    multiple of :data:`DECODE_BLOCK`; the path runs when the generation
    fills at least one block, stays within :data:`MAX_UNROLLED_BLOCKS`, the
    padding fits the learned position table (RoPE is unbounded), and the
    prompt has more than one token — inside the blocked module ``s == 1``
    means a decode step, so a one-token prefill would orphan its K/V in the
    ring."""
    T = DECODE_BLOCK
    n_steps = max_new_tokens - 1
    n_blocks = -(-n_steps // T)
    padded_total = prompt_len + n_blocks * T
    blocked = (
        n_steps >= T
        and n_blocks <= MAX_UNROLLED_BLOCKS
        and prompt_len > 1
        and (getattr(model, "pos_encoding", "learned") == "rope"
             or padded_total <= getattr(model, "max_len", padded_total))
    )
    return blocked, padded_total


@torch.no_grad()
def generate(model: TransformerLM, prompt, max_new_tokens: int, temperature: float = 0.0,
             seed: Optional[int] = None, top_k: int = 0, top_p: float = 1.0,
             kv_quant: bool = False) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations of ``prompt`` (``[B, P]`` ids).

    Returns ``[B, P + max_new_tokens]`` int64 tokens on ``model``'s device.
    ``temperature=0`` is greedy; otherwise categorical sampling (``seed``
    required) with optional ``top_k`` / ``top_p``. ``kv_quant=True`` stores
    completed blocks' K/V as int8 with per-key scales; it applies only when
    the blocked path runs, and a shape that falls back to the plain path
    keeps the exact cache with a ``UserWarning`` (pre-check with
    :func:`uses_block_decode`)."""
    if temperature > 0.0 and seed is None:
        raise ValueError("temperature > 0 sampling needs a seed")
    seed = 0 if seed is None else int(seed)
    dev = next(model.parameters()).device
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p = prompt.shape
    _check_max_len(model, p + max_new_tokens)
    if max_new_tokens < 1:
        return prompt
    blocked, padded_total = uses_block_decode(model, p, max_new_tokens)
    if blocked:
        dec = _decode_model(model, padded_total, DECODE_BLOCK, kv_quant)
        cache = init_cache(model, b, padded_total, DECODE_BLOCK, kv_quant)
        return _generate_blocked(dec, max_new_tokens, temperature, top_k, top_p, cache,
                                 prompt, seed)
    if kv_quant:
        warnings.warn(
            "kv_quant=True requested but this shape falls back to the plain decode "
            "path (int8 quantization only exists under the blocked path: needs "
            f"prompt_len > 1 and {DECODE_BLOCK} <= max_new_tokens - 1 <= "
            f"{DECODE_BLOCK * MAX_UNROLLED_BLOCKS}, within max_len) — using the exact "
            "full-size cache; the halved-footprint capacity win does not apply",
            stacklevel=3)  # the caller, past torch.no_grad's wrapper
    total = p + max_new_tokens
    dec = _decode_model(model, total)
    cache = init_cache(model, b, total)
    return _generate_plain(dec, max_new_tokens, temperature, top_k, top_p, cache, prompt,
                           seed)


def _sampler(temperature, top_k, top_p, seed, device):
    def sample(logits, g):
        gen = step_generator(seed, g, device) if temperature > 0.0 else None
        return sample_tokens(logits, gen, temperature, top_k, top_p)
    return sample


def _generate_plain(dec, max_new_tokens, temperature, top_k, top_p, cache, prompt, seed):
    """Prefill, then one-token steps appending to the full cache."""
    b, p = prompt.shape
    sample = _sampler(temperature, top_k, top_p, seed, prompt.device)
    positions = torch.arange(p, device=prompt.device)[None, :]
    logits, cache = dec(prompt, positions, cache=cache)
    tok = sample(logits[:, -1], 0)
    out = [tok]
    for t in range(max_new_tokens - 1):
        pos = torch.full((b, 1), p + t, device=prompt.device)
        logits, cache = dec(tok[:, None], pos, cache=cache)
        tok = sample(logits[:, -1], t + 1)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def _tree_slice_big(big, live: int):
    """Live-prefix views of every big cache: ``(b, h, C, d) -> (b, h, live,
    d)`` and scales ``(b, h, C) -> (b, h, live)`` — views, not copies, so
    each block reads the K/V written so far through the cache's strides."""
    return {name: (_tree_slice_big(val, live) if isinstance(val, dict)
                   else val[:, :, :live]) for name, val in big.items()}


def merge_ring_caches(big, small, live):
    """Write every layer's ring into its full big cache at offset ``live``,
    in place, and return ``big``. ``live`` is an int (one offset for the
    batch, the blocked :func:`generate`) or a ``(B,)`` tensor (per-row
    offsets, the slot pool). An int8 cache (scales present) quantizes the
    exact ring here, once per block. Rings are reused as they are: the next
    block's ring mask hides their stale slots."""
    if "cached_k" in big:
        rk, rv = small["ring_k"], small["ring_v"]
        parts = [("cached_k", rk), ("cached_v", rv)]
        if "scale_k" in big:
            rk8, ks = quantize_kv(rk)
            rv8, vs = quantize_kv(rv)
            parts = [("cached_k", rk8), ("cached_v", rv8), ("scale_k", ks), ("scale_v", vs)]
        for name, val in parts:
            if isinstance(live, int):
                big[name][:, :, live:live + val.shape[2]] = val
            else:
                write_rows(big[name], val, live.long())
        return big
    for name, val in big.items():
        if isinstance(val, dict):
            merge_ring_caches(val, small.get(name, {}), live)
    return big


def reset_ring_state(small, live):
    """Per-block small-state reset: ``cursor`` and ``ring_base`` both at the
    block's start ``live`` (an int or a per-row tensor); rings keep their
    stale data (masked out)."""
    out = {}
    for name, val in small.items():
        if isinstance(val, dict):
            out[name] = reset_ring_state(val, live)
        elif name in ("cursor", "ring_base"):
            out[name] = torch.as_tensor(live, dtype=torch.int32,
                                        device=val.device).expand(val.shape).clone()
        else:
            out[name] = val
    return out


def _generate_blocked(dec, max_new_tokens, temperature, top_k, top_p, cache, prompt, seed):
    """Ring-buffered decode: blocks of ``decode_block`` single-token steps.
    Steps write the small per-layer rings; each block reads the big caches
    through a live-prefix view of ``p + blk * T`` rows, and the rings are
    merged into the big caches once per block. The step loop is padded to
    whole blocks; the padded steps' tokens are dropped, and their K/V lands
    after every real token's, where no real step reads it."""
    T = dec.decode_block
    b, p = prompt.shape
    n_blocks = -(-(max_new_tokens - 1) // T)
    sample = _sampler(temperature, top_k, top_p, seed, prompt.device)
    logits, cache = dec(prompt, torch.arange(p, device=prompt.device)[None, :], cache=cache)
    big, small = split_cache(cache)
    tok = sample(logits[:, -1], 0)
    fed = []
    pos0 = torch.full((b, 1), p, device=prompt.device)
    for blk in range(n_blocks):
        live = p + blk * T
        big_view = _tree_slice_big(big, live)
        small = reset_ring_state(small, live)
        for t in range(T):
            step = blk * T + t
            logits, cache = dec(tok[:, None], pos0 + step, cache=join_cache(big_view, small))
            _, small = split_cache(cache)
            fed.append(tok)
            tok = sample(logits[:, -1], step + 1)
        big = merge_ring_caches(big, small, live)
    generated = torch.stack(fed + [tok], dim=1)
    return torch.cat([prompt, generated[:, :max_new_tokens]], dim=1)
