"""The port's decode path (``models/transformer.py`` decode branch,
``models/generate.py``) against the JAX package's, on the CPU.

The model is tiny (vocab 64, d_model 32, 4 heads of 8, 2 layers, d_ff 64),
float32; weights cross with ``utils/interop.params_from_jax`` and caches
with ``cache_from_jax`` / ``cache_to_jax``. Inputs come from numpy.

Tolerances: cached logits against the full forward 2e-4 relative and 2e-5
absolute (the JAX test's); teacher-forced decode logits against the JAX
decode model 1e-5 absolute, step by step, plain and blocked, with and
without ``kv_quant`` (the same functions with sums in other orders; the int8
quantization itself is bit-equal). Greedy tokens must equal JAX's where the
JAX logits' top-2 margin is at least 1e-3 at every step (asserted), a
hundred times that tolerance. Sampled streams cannot equal JAX's
(``jax.random``'s bits are not PyTorch's): the sampler's support is held
equal on the same logits instead.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.models.transformer import TransformerLM as JLM
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.utils import interop

# the packages' ``models`` re-export the function ``generate`` over the module
jgen = importlib.import_module("distributed_ml_pytorch_tpu.models.generate")
tgen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=128)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=0, atol=1e-5)
MARGIN = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(seed=1, **cfg):
    cfg = {**CFG, **cfg}
    jlm = JLM(**cfg)
    params = jlm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(**cfg, device="cpu")
    model.load_state_dict(interop.params_from_jax(jax.tree.map(np.asarray, params), model))
    return jlm, params, model


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], size=shape).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def test_incremental_decode_matches_full_forward():
    jlm, params, model = _pair()
    tok = _tokens((2, 10), 0)
    full = model(_t(tok)).detach().numpy()
    np.testing.assert_allclose(full, np.asarray(jlm.apply({"params": params}, tok)),
                               **LOGIT_TOL)
    dec = tgen._decode_model(model, 10)
    cache = tgen.init_cache(model, 2, 10)
    got = []
    with torch.no_grad():
        for t in range(10):
            logits, cache = dec(_t(tok[:, t:t + 1]), torch.full((2, 1), t), cache=cache)
            got.append(logits[:, 0].numpy())
    np.testing.assert_allclose(np.stack(got, 1), full, **LOGIT_TOL)


@pytest.mark.parametrize("decode_block,kv_quant", [(0, False), (4, False), (4, True)])
def test_prefill_block_matches_full_forward(decode_block, kv_quant):
    _, _, model = _pair()
    tok = _tokens((2, 8), 1)
    full = model(_t(tok)).detach().numpy()
    dec = tgen._decode_model(model, 8, decode_block, kv_quant)
    cache = tgen.init_cache(model, 2, 8, decode_block, kv_quant)
    with torch.no_grad():
        logits, cache = dec(_t(tok), torch.arange(8)[None], cache=cache)
    np.testing.assert_allclose(logits.numpy(), full, **LOGIT_TOL)
    assert int(cache["block_0"]["attn"]["cursor"]) == 8


def _jax_steps(jlm, params, prompt, feed, blocked, kv_quant):
    """JAX decode logits: prefill, then ``feed``'s tokens one step at a time
    (blocked: two blocks of 16 with ring merges, as ``_generate_blocked_jit``)."""
    b, p = prompt.shape
    n = feed.shape[1]
    T = jgen.DECODE_BLOCK if blocked else 0
    total = p + n
    dec = jgen._decode_model(jlm, total, decode_block=T, kv_quant=kv_quant)
    cache = jgen.init_cache(jlm, b, total, decode_block=T, kv_quant=kv_quant)
    prm = jgen._fuse_qkv_params(params) if blocked else params
    logits, mut = dec.apply({"params": prm, "cache": cache}, prompt, jnp.arange(p)[None],
                            mutable=["cache"])
    first_cache = mut["cache"]
    out = [np.asarray(logits[:, -1])]
    cache = first_cache
    if not blocked:
        for t in range(n):
            logits, mut = dec.apply({"params": prm, "cache": cache}, feed[:, t:t + 1],
                                    jnp.full((b, 1), p + t), mutable=["cache"])
            cache = mut["cache"]
            out.append(np.asarray(logits[:, -1]))
        return np.stack(out, 1), first_cache
    big, small = jgen.split_cache(cache)
    for blk in range(n // T):
        live = p + blk * T
        dec_blk = dec.clone(cache_size=live)
        view = jgen._tree_slice_big(big, live)
        small = jgen.reset_ring_state(small, live)
        for t in range(T):
            step = blk * T + t
            logits, mut = dec_blk.apply(
                {"params": prm, "cache": jgen.join_cache(view, small)},
                feed[:, step:step + 1], jnp.full((b, 1), p + step), mutable=["cache"])
            _, small = jgen.split_cache(mut["cache"])
            out.append(np.asarray(logits[:, -1]))
        big = jgen.merge_ring_caches(big, small, live)
    return np.stack(out, 1), first_cache


def _port_steps(model, prompt, feed, blocked, kv_quant, cache=None):
    b, p = prompt.shape
    n = feed.shape[1]
    T = tgen.DECODE_BLOCK if blocked else 0
    total = p + n
    dec = tgen._decode_model(model, total, T, kv_quant)
    out = []
    with torch.no_grad():
        if cache is None:
            cache = tgen.init_cache(model, b, total, T, kv_quant)
            logits, cache = dec(_t(prompt), torch.arange(p)[None], cache=cache)
            out.append(logits[:, -1].numpy())
        if not blocked:
            for t in range(n):
                logits, cache = dec(_t(feed[:, t:t + 1]), torch.full((b, 1), p + t),
                                    cache=cache)
                out.append(logits[:, -1].numpy())
            return np.stack(out, 1)
        big, small = tgen.split_cache(cache)
        for blk in range(n // T):
            live = p + blk * T
            view = tgen._tree_slice_big(big, live)
            small = tgen.reset_ring_state(small, live)
            for t in range(T):
                step = blk * T + t
                logits, c = dec(_t(feed[:, step:step + 1]), torch.full((b, 1), p + step),
                                cache=tgen.join_cache(view, small))
                _, small = tgen.split_cache(c)
                out.append(logits[:, -1].numpy())
            big = tgen.merge_ring_caches(big, small, live)
    return np.stack(out, 1)


@pytest.mark.parametrize("blocked,kv_quant", [(False, False), (True, False), (True, True)],
                         ids=["plain", "blocked", "blocked-kv_quant"])
def test_teacher_forced_logits_match_jax_decode_model(blocked, kv_quant):
    jlm, params, model = _pair()
    prompt, feed = _tokens((2, 5), 2), _tokens((2, 32), 3)
    want, jcache = _jax_steps(jlm, params, jnp.asarray(prompt), jnp.asarray(feed), blocked,
                              kv_quant)
    got = _port_steps(model, prompt, feed, blocked, kv_quant)
    np.testing.assert_allclose(got, want, **STEP_TOL)
    # the JAX prefill's cache carried across continues the same way
    cache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache))
    from_jax = _port_steps(model, prompt, feed, blocked, kv_quant, cache=cache)
    np.testing.assert_allclose(from_jax, want[:, 1:], **STEP_TOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_interop_round_trip_matches_jax_layout(kv_quant):
    jlm, params, model = _pair()
    prompt = _tokens((2, 6), 4)
    T = jgen.DECODE_BLOCK
    jcache = jax.tree.map(np.asarray, jgen.init_cache(jlm, 2, 24, T, kv_quant))
    _, mut = jgen._decode_model(jlm, 24, T, kv_quant).apply(
        {"params": jgen._fuse_qkv_params(params), "cache": jcache}, jnp.asarray(prompt),
        jnp.arange(6)[None], mutable=["cache"])
    want = jax.tree.map(np.asarray, mut["cache"])
    dec = tgen._decode_model(model, 24, T, kv_quant)
    with torch.no_grad():
        _, cache = dec(_t(prompt), torch.arange(6)[None],
                       cache=tgen.init_cache(model, 2, 24, T, kv_quant))
    got = interop.cache_to_jax(cache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == np.int8:  # quantized K/V: one step where a product rounds apart
            assert np.abs(a.astype(int) - b).max() <= 1, path
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=str(path))


def test_bf16_cache_interop_round_trip():
    jlm = JLM(**CFG, dtype=jnp.bfloat16)
    jcache = jax.tree.map(np.asarray, jgen.init_cache(jlm, 2, 16, 8))
    rng = np.random.default_rng(5)
    jcache["block_0"]["attn"]["ring_k"] = rng.normal(size=(2, 4, 8, 8)).astype(jnp.bfloat16)
    port = interop.cache_from_jax(jcache)
    assert port["block_0"]["attn"]["ring_k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(port["block_0"]["attn"]["ring_k"].float().numpy(),
                                  jcache["block_0"]["attn"]["ring_k"].astype(np.float32))
    back = interop.cache_to_jax(port)
    assert back["block_0"]["attn"]["ring_k"].dtype == np.uint16
    np.testing.assert_array_equal(back["block_0"]["attn"]["ring_k"].view(jnp.bfloat16),
                                  jcache["block_0"]["attn"]["ring_k"])
    assert back["block_0"]["attn"]["cursor"].dtype == np.int32


def _min_margin(jlm, params, out, p):
    logits = np.asarray(jlm.apply({"params": params}, out))[:, p - 1:-1]
    top2 = np.sort(logits, -1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.mark.parametrize("seed,prompt_seed", [(1, 0), (1, 1), (4, 0), (4, 2)])
@pytest.mark.parametrize("new,kv_quant", [(6, False), (35, False), (35, True)],
                         ids=["plain", "blocked", "blocked-kv_quant"])
def test_greedy_generate_tokens_equal_jax(seed, prompt_seed, new, kv_quant):
    jlm, params, model = _pair(seed)
    prompt = _tokens((2, 5), prompt_seed)
    want = np.asarray(jgen.generate(jlm, params, jnp.asarray(prompt), new, kv_quant=kv_quant))
    assert _min_margin(jlm, params, want, 5) >= MARGIN
    got = tgen.generate(model, prompt, new, kv_quant=kv_quant)
    assert tgen.uses_block_decode(model, 5, new)[0] == (new > 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_blocked_decode_matches_unblocked_path():
    _, _, model = _pair()
    prompt = _t(_tokens((2, 5), 2))
    n = 2 * tgen.DECODE_BLOCK + 3  # crosses two merges and a padded tail
    blocked = tgen.generate(model, prompt, n)
    total = 5 + n
    with torch.no_grad():
        ref = tgen._generate_plain(tgen._decode_model(model, total), n, 0.0, 0, 1.0,
                                   tgen.init_cache(model, 2, total), prompt, 0)
    assert torch.equal(blocked, ref)


def test_single_token_prompt_long_generation_matches_rollout_and_jax():
    jlm, params, model = _pair(4, max_len=64)
    prompt = np.asarray([[7], [13]], np.int32)
    assert not tgen.uses_block_decode(model, 1, 20)[0]
    got = tgen.generate(model, prompt, 20)
    seq = _t(prompt)
    for _ in range(20):
        nxt = model(seq)[:, -1].argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], 1)
    assert torch.equal(got, seq)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgen.generate(jlm, params, jnp.asarray(prompt), 20)))


def test_kv_quant_decode_deterministic_and_first_token_exact():
    _, _, model = _pair()
    prompt = _tokens((2, 6), 5)
    exact = tgen.generate(model, prompt, 40)
    q1 = tgen.generate(model, prompt, 40, kv_quant=True)
    q2 = tgen.generate(model, prompt, 40, kv_quant=True)
    assert torch.equal(q1, q2) and q1.shape == exact.shape
    assert int(q1.max()) < 64 and int(q1.min()) >= 0
    assert torch.equal(q1[:, 6], exact[:, 6])


def test_kv_quant_fallback_warns_and_quant_prefill_needs_empty_cache():
    _, _, model = _pair()
    prompt = _tokens((1, 6), 5)
    with pytest.warns(UserWarning, match="kv_quant.*fall"):
        out = tgen.generate(model, prompt, 4, kv_quant=True)
    assert out.shape == (1, 10)
    with pytest.raises(ValueError, match="decode_block"):
        tgen._decode_model(model, 16, kv_quant=True)
    # a second prefill into a non-empty int8 cache is poisoned with NaN
    dec = tgen._decode_model(model, 32, 8, True)
    cache = tgen.init_cache(model, 1, 32, 8, True)
    with torch.no_grad():
        first, cache = dec(_t(prompt), torch.arange(6)[None], cache=cache)
        second, _ = dec(_t(prompt), torch.arange(6, 12)[None], cache=cache)
    assert bool(torch.isfinite(first).all()) and bool(torch.isnan(second).all())


def test_fuse_qkv_rewrites_only_attn_modules_and_keeps_logits():
    w = torch.ones(4, 4)
    state = {"block_0.attn.q.weight": w, "block_0.attn.k.weight": 2 * w,
             "block_0.attn.v.weight": 3 * w, "block_0.attn.o.weight": w,
             "block_0.lookup.q.weight": w, "block_0.lookup.k.weight": w,
             "block_0.lookup.v.weight": w}
    out = tgen._fuse_qkv_params(state)
    assert set(out) == {"block_0.attn.qkv.weight", "block_0.attn.o.weight",
                        "block_0.lookup.q.weight", "block_0.lookup.k.weight",
                        "block_0.lookup.v.weight"}
    assert out["block_0.attn.qkv.weight"].shape == (12, 4)
    assert float(out["block_0.attn.qkv.weight"][8, 0]) == 3.0
    with pytest.raises(ValueError, match="same-shaped"):
        tgen._fuse_qkv_params(dict(state, **{"block_0.attn.k.weight": torch.ones(4, 5)}))
    # the fused decode model gives the unfused model's logits, and the JAX
    # unfused tree loads into a fused model as the same fusion
    jlm, params, model = _pair()
    tok = _tokens((2, 8), 6)
    dec = tgen._decode_model(model, 8, 4)
    assert dec.fused_qkv and not model.fused_qkv
    with torch.no_grad():
        logits, _ = dec(_t(tok), torch.arange(8)[None], cache=tgen.init_cache(model, 2, 8, 4))
    np.testing.assert_allclose(logits.numpy(), model(_t(tok)).detach().numpy(), **LOGIT_TOL)
    fused = TransformerLM(**CFG, fused_qkv=True, device="cpu")
    loaded = interop.params_from_jax(jax.tree.map(np.asarray, params), fused)
    for name, val in tgen._fuse_qkv_params(model.state_dict()).items():
        assert torch.equal(loaded[name], val), name


def test_decode_model_is_cast_once_and_shares_nothing():
    model = TransformerLM(**CFG, dtype=torch.bfloat16, device="cpu")
    dec = tgen._decode_model(model, 16, 8)
    assert dec.lm_head.weight.dtype == torch.bfloat16
    assert dec.tok_embed.weight.dtype == torch.bfloat16
    assert dec.LayerNorm_0.weight.dtype == torch.float32
    assert torch.equal(dec.lm_head.weight, model.lm_head.weight.to(torch.bfloat16))
    ptrs = {p.data_ptr() for p in model.parameters()}
    assert not any(p.data_ptr() in ptrs for p in dec.parameters())


def test_decode_rejects_injected_attn_fn_and_missing_cache():
    model = TransformerLM(**CFG, decode=True, cache_size=8, attn_fn=lambda q, k, v: q,
                          device="cpu")
    with pytest.raises(ValueError, match="attn_fn"):
        model(torch.zeros((1, 1), dtype=torch.long), cache=tgen.init_cache(model, 1, 8))
    model.set_attn_fn(None)
    with pytest.raises(ValueError, match="cache"):
        model(torch.zeros((1, 1), dtype=torch.long))


def test_generate_guards():
    _, _, model = _pair(max_len=64)
    prompt = _tokens((1, 2), 0)
    with pytest.raises(ValueError, match="seed"):
        tgen.generate(model, prompt, 4, temperature=0.7)
    with pytest.raises(ValueError, match="max_len"):
        tgen.generate(model, prompt, 63)
    assert torch.equal(tgen.generate(model, prompt, 0), _t(prompt))


def test_init_cache_layouts_match_jax():
    jlm, _, model = _pair()
    for kw in (dict(), dict(decode_block=8), dict(decode_block=8, kv_quant=True)):
        want = jax.tree.map(np.asarray, jgen.init_cache(jlm, 2, 32, **kw))
        got = interop.cache_to_jax(tgen.init_cache(model, 2, 32, **kw))
        assert jax.tree.structure(got) == jax.tree.structure(want), kw
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype and not a.any(), kw


def test_sampled_generate_reproducible_varied_and_in_vocab():
    _, _, model = _pair()
    prompt = _tokens((1, 4), 0)
    kw = dict(temperature=0.9, top_k=10, top_p=0.9)
    a = tgen.generate(model, prompt, 20, seed=3, **kw)
    b = tgen.generate(model, prompt, 20, seed=3, **kw)
    c = tgen.generate(model, prompt, 20, seed=4, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < 64 and int(a.min()) >= 0


def _supports(logits, n, **kw):
    """Tokens each package's sampler draws over ``n`` keys / seeds, per row."""
    jl = jnp.asarray(logits)
    tl = torch.from_numpy(logits)
    jset = [set() for _ in range(logits.shape[0])]
    tset = [set() for _ in range(logits.shape[0])]
    for i in range(n):
        jt = np.asarray(jgen.sample_tokens(jl, jax.random.key(i), **kw))
        tt = tgen.sample_tokens(tl, tgen.step_generator(i, 0, "cpu"), **kw).numpy()
        for r in range(logits.shape[0]):
            jset[r].add(int(jt[r]))
            tset[r].add(int(tt[r]))
    return jset, tset


@pytest.mark.parametrize("kw,want", [
    (dict(temperature=1.0, top_k=3, top_p=0.85), [{0, 1}]),
    (dict(temperature=1.0, top_k=3), [{0, 1, 2}]),
    (dict(temperature=1.0, top_p=0.85), [{0, 1, 2}]),
    (dict(temperature=1.0, top_p=0.75), None),
])
def test_sampler_support_equals_jax_on_the_same_logits(kw, want):
    probs = [0.5, 0.3, 0.12, 0.08] if want is not None else [0.5, 0.3, 0.1, 0.1]
    logits = np.log(np.asarray([probs], np.float32))
    jset, tset = _supports(logits, 150, **kw)
    assert tset == jset
    if want is not None:
        assert tset == want
    else:
        assert tset == [{0, 1}]


def test_sampler_topk_and_greedy_equivalents_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(4, 64)).astype(np.float32)
    jset, tset = _supports(logits, 50, temperature=1.0, top_k=5)
    top5 = np.argsort(logits, -1)[:, -5:]
    for r in range(4):
        assert tset[r] <= set(top5[r]) and jset[r] <= set(top5[r])
    greedy = logits.argmax(-1)
    for i in range(10):
        g = tgen.step_generator(i, 0, "cpu")
        for kw in (dict(top_k=1), dict(top_p=1e-9)):
            got = tgen.sample_tokens(torch.from_numpy(logits), g, temperature=0.7, **kw)
            np.testing.assert_array_equal(got.numpy(), greedy)
    with pytest.raises(ValueError, match="generator"):
        tgen.sample_tokens(torch.from_numpy(logits), None, temperature=0.5)


def test_sample_tokens_dynamic_matches_scalar_rowwise():
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 64)).astype(np.float32) * 2)
    configs = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.7, 5, 1.0), (0.7, 0, 0.9), (1.3, 8, 0.85),
               (0.5, 1, 1.0), (0.9, 64 + 10, 0.5)]
    for i, (t, k, p) in enumerate(configs):
        for row in range(5):
            gen = lambda: tgen.step_generator(100 + i, row, "cpu") if t > 0 else None
            want = tgen.sample_tokens(logits[row][None], gen(), temperature=t, top_k=k, top_p=p)
            got = tgen.sample_tokens_dynamic(logits[row][None], [gen()], [t], [k], [p])
            assert int(got[0]) == int(want[0]), (t, k, p, row)
    # a heterogeneous batch equals its rows alone
    temps, ks, ps = [0.0, 0.8, 1.2, 0.6, 0.0], [0, 5, 0, 3, 2], [1.0, 1.0, 0.8, 0.7, 0.5]
    gens = lambda: [tgen.step_generator(r, 7, "cpu") if temps[r] > 0 else None
                    for r in range(5)]
    batched = tgen.sample_tokens_dynamic(logits, gens(), temps, ks, ps)
    for r in range(5):
        alone = tgen.sample_tokens_dynamic(logits[r][None], [gens()[r]], [temps[r]], [ks[r]],
                                           [ps[r]])
        assert int(batched[r]) == int(alone[0])
