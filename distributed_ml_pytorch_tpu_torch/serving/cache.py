"""Slot-based KV cache pool — the serving data plane (counterpart of the JAX
``serving/cache.py``).

``models/generate.py`` decodes one prompt batch that starts together and
shares one cursor. A serving engine needs ``slots`` long-lived cache slots,
each holding an independent sequence at its own length, all advanced by one
decode step per token. The JAX pool gets per-slot lengths by ``jax.vmap``
over batch-1 lanes; here the attention module itself takes per-row state:
the pool's cache is the blocked decode cache of ``generate()`` with batch =
``slots`` and with every layer's ``cursor`` / ``ring_base`` a ``(slots,)``
vector. A single-token step then masks each row by its own ``ring_base`` and
``t = cursor - ring_base`` (the decode-attention kernel K8 reads both per
row on the device) and writes each row's ring at its own slot; once per
block the rings merge into the big caches at per-slot offsets. Slot lengths
differ, so steps read the full allocation under the per-row mask (K8 reads
only the live keys).

Admission (prefill) runs per request on a fresh zeroed batch-1 lane, which
is copied into the pool at the target slot. That freshness keeps slot reuse
safe under ``kv_quant``: the int8 cache's single-prefill contract
(``models/generate.init_cache``) needs the first multi-token call at cursor
0, and a recycled slot always restarts from a zero lane. Prompts may be
right-padded to a bucket length: the padded positions write garbage K/V
past the prompt, causal masking keeps the real logits exact, the cursor is
rewound to the true length, and the ``key < ring_base`` mask hides the
garbage until decode merges overwrite it.

Exactness contract (CPU): a request decoded through the pool picks token
for token what a standalone ``generate()`` picks for the same ``(model,
prompt, seed)`` — the same attention math, masked cache tails contributing
exact zeros, and token ``g`` drawn from the generator of ``(seed, g)``.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_ml_pytorch_tpu_torch.models.generate import (
    DECODE_BLOCK,
    _decode_model,
    init_cache,
    join_cache,
    merge_ring_caches,
    sample_tokens_dynamic,
    split_cache,
    step_generator,
)


def find_cache_leaf(tree, name: str):
    """First leaf called ``name`` in a cache tree (sorted traversal). Every
    layer carries its own ``cursor``/``ring_base`` and the blocked decode
    advances them in lockstep, so any one is the per-slot truth."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            val = tree[key]
            if key == name and not isinstance(val, dict):
                return val
            if isinstance(val, dict):
                found = find_cache_leaf(val, name)
                if found is not None:
                    return found
    return None


def replace_cache_leaves(tree, mapping):
    """Rebuild a cache tree with every leaf named in ``mapping`` replaced by
    the mapped value, cast to the leaf's dtype and broadcast to its shape."""
    out = {}
    for name, val in tree.items():
        if isinstance(val, dict):
            out[name] = replace_cache_leaves(val, mapping)
        elif name in mapping:
            new = torch.as_tensor(mapping[name], device=val.device).to(val.dtype)
            out[name] = new.expand(val.shape).clone()
        else:
            out[name] = val
    return out


def _leaves(tree, prefix=()):
    """``(path, tensor)`` of every leaf, keys sorted at each level."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


class SlotKVPool:
    """Fixed-capacity pool of ``slots`` independent KV cache slots of
    ``cache_size`` rows each, over the blocked decode module of ``model``.

    The pool is the data plane; the scheduler (``serving/engine.py``) owns
    which slot belongs to which request. Per-request sampling state (seed,
    temperature, top-k, top-p) is passed per call, so one decode step serves
    any mix of greedy and sampled requests. The decode model's weights are
    ``model``'s cast to the activation dtype once, here.
    """

    def __init__(self, model, *, slots: int, cache_size: int,
                 decode_block: int = DECODE_BLOCK, kv_quant: bool = False):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if decode_block < 1:
            raise ValueError(
                "the slot pool rides the ring-buffered blocked cache — decode_block "
                f"must be >= 1, got {decode_block}")
        max_len = getattr(model, "max_len", None)
        if (max_len is not None and cache_size > max_len
                and getattr(model, "pos_encoding", "learned") != "rope"):
            raise ValueError(
                f"cache_size {cache_size} exceeds the model's learned position table "
                f"max_len={max_len} (RoPE models have no such bound)")
        self.slots = int(slots)
        self.cache_size = int(cache_size)
        self.decode_block = int(decode_block)
        self.kv_quant = bool(kv_quant)
        self.model = model
        self.device = next(model.parameters()).device
        self.dec = _decode_model(model, self.cache_size, self.decode_block, self.kv_quant)
        self.cache = init_cache(model, self.slots, self.cache_size, self.decode_block,
                                self.kv_quant)
        for path, _ in list(_leaves(self.cache)):
            if path[-1] in ("cursor", "ring_base"):  # one per slot
                _get(self.cache, path[:-1])[path[-1]] = torch.zeros(
                    self.slots, dtype=torch.int32, device=self.device)

    def _lane(self):
        return init_cache(self.model, 1, self.cache_size, self.decode_block, self.kv_quant)

    @torch.no_grad()
    def admit(self, slot: int, prompt: np.ndarray, real_len: int, *, seed: int = 0,
              temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
              gen_offset: int = 0) -> int:
        """Prefill a (bucketed) prompt into ``slot``; returns the request's
        first sampled token. ``gen_offset`` resumes the sampling schedule at
        that generated-token index (0 for a fresh request)."""
        prompt = torch.as_tensor(np.asarray(prompt), device=self.device).long()[None, :]
        if prompt.shape[1] < 2:
            # s == 1 is the decode-step discriminator inside the blocked
            # module: a 1-token "prefill" would write the ring and orphan the
            # prompt's K/V — callers pad 1-token prompts (ServingEngine)
            raise ValueError(
                "admit() needs a prompt of length >= 2 — pad 1-token prompts (a "
                "length-1 call is a decode step, not a prefill)")
        bucket = prompt.shape[1]
        positions = torch.arange(bucket, device=self.device)[None, :]
        logits, lane = self.dec(prompt, positions, cache=self._lane())
        # rewind cursor/ring_base from the padded bucket end to the prompt's
        # true length: the pad's K/V is hidden by the ring_base mask
        lane = replace_cache_leaves(lane, {"cursor": real_len, "ring_base": real_len})
        last = logits[0, real_len - 1][None]
        gen = (step_generator(seed, gen_offset, self.device)
               if temperature > 0.0 else None)
        tok0 = sample_tokens_dynamic(last, [gen], [temperature], [top_k], [top_p])[0]
        for path, leaf in _leaves(lane):
            _get(self.cache, path)[slot] = leaf[0] if leaf.dim() else leaf
        return int(tok0)

    @torch.no_grad()
    def decode_block_step(self, tok, n_gen, seeds, temps, top_ks, top_ps,
                          active) -> np.ndarray:
        """Advance every slot by one ``decode_block``-token block; returns the
        sampled tokens ``[slots, decode_block]`` as a host array (the fetch is
        the block's one device sync). Slots where ``active`` is False decode
        garbage from a zeroed state and are re-zeroed on exit. Token ``g`` of
        a slot is drawn from the generator of ``(seeds[i], g)``, with ``g``
        starting at ``n_gen[i]``."""
        T = self.decode_block
        n_gen = np.asarray(n_gen, np.int64)
        temps = np.asarray(temps, np.float32)
        big, small = split_cache(self.cache)
        base = find_cache_leaf(small, "ring_base").clone()
        tok = torch.as_tensor(np.asarray(tok), device=self.device).long()
        toks = []
        for step in range(T):
            cursor = find_cache_leaf(small, "cursor")
            logits, cache = self.dec(tok[:, None], cursor.long()[:, None],
                                     cache=join_cache(big, small))
            _, small = split_cache(cache)
            gens = [step_generator(int(seeds[i]), int(n_gen[i]) + step, self.device)
                    if temps[i] > 0.0 else None for i in range(self.slots)]
            tok = sample_tokens_dynamic(logits[:, -1], gens, temps, top_ks, top_ps)
            toks.append(tok)
        act = torch.as_tensor(np.asarray(active, bool), device=self.device)
        zero = torch.zeros((), dtype=base.dtype, device=self.device)
        merge_ring_caches(big, small, torch.where(act, base, zero))
        cursor = find_cache_leaf(small, "cursor")
        small = replace_cache_leaves(small, {
            "cursor": torch.where(act, cursor, zero),
            "ring_base": torch.where(act, base + T, zero)})
        self.cache = join_cache(big, small)
        return torch.stack(toks, dim=1).cpu().numpy()

    def reset_slots(self, slot_indices) -> None:
        """Mark the given slots empty (cursor/ring_base back to 0): their
        cache contents become invisible and their live length reads 0."""
        idx = torch.as_tensor(list(slot_indices), dtype=torch.long, device=self.device)
        for path, leaf in _leaves(self.cache):
            if path[-1] in ("cursor", "ring_base"):
                leaf[idx] = 0

    def slot_kv(self, slot: int) -> np.ndarray:
        """One slot's KV lane as a flat float32 vector: every floating cache
        leaf's row for ``slot``, concatenated in sorted tree order (under
        ``kv_quant`` the int8 caches are not floating: the scales and rings
        are)."""
        parts = [leaf[slot].float().cpu().numpy().ravel()
                 for _, leaf in _leaves(self.cache) if leaf.is_floating_point()]
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    def live_lengths(self) -> np.ndarray:
        """Per-slot live sequence length (prompt + generated), from the
        cache's own cursors."""
        return find_cache_leaf(self.cache, "cursor").cpu().numpy().reshape(self.slots)

    def blocks_needed(self, max_new_tokens: int) -> int:
        """Decode blocks a request of ``max_new_tokens`` occupies a slot for
        (its first token comes from prefill, the rest from whole blocks)."""
        return -(-(max_new_tokens - 1) // self.decode_block)

    def capacity_needed(self, prompt_len: int, bucket_len: int, max_new_tokens: int) -> int:
        """Cache rows the request can touch: the padded prefill writes up to
        ``bucket_len``; block-granular decode merges from the true prompt
        length through the rounded-up tail block."""
        decoded = self.blocks_needed(max_new_tokens) * self.decode_block
        return max(bucket_len, prompt_len + decoded)
