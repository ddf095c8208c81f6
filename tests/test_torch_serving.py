"""The port's continuous-batching engine and slot pool, on the CPU, beside
the JAX package's (``tests/test_serving.py`` is the list mirrored).

The load-bearing property is arrival-order-independent exactness: whatever
mix of requests shares the pool, a request's tokens equal the port's own
``generate()`` for the same ``(model, prompt, seed)`` — greedy and sampled —
and greedy requests equal the JAX engine's on the same weights (where the
JAX logits' top-2 margins are at least 1e-3, asserted). The model is tiny
(vocab 64, d_model 32, 4 heads, 2 layers), float32, weights carried across
with ``utils/interop.params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.models.transformer import TransformerLM as JLM
from distributed_ml_pytorch_tpu.serving.engine import ServingEngine as JEngine
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.models.generate import generate
from distributed_ml_pytorch_tpu_torch.serving import cache as pool_mod
from distributed_ml_pytorch_tpu_torch.serving.engine import QueueFullError, ServingEngine
from distributed_ml_pytorch_tpu_torch.utils import interop

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=128)
MARGIN = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lm():
    jlm = JLM(**CFG)
    params = jlm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(**CFG, device="cpu")
    model.load_state_dict(interop.params_from_jax(jax.tree.map(np.asarray, params), model))
    return jlm, params, model


def make_engine(model, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("cache_size", 96)
    kw.setdefault("decode_block", 4)
    kw.setdefault("prefill_bucket", 8)
    return ServingEngine(model, **kw)


def ref_tokens(model, prompt, max_new, **kw):
    """The port's standalone ``generate()`` continuation (the oracle)."""
    out = generate(model, np.asarray(prompt, np.int32)[None], max_new, **kw)
    return out[0, len(prompt):].tolist()


def prompts(seed, size):
    return np.random.default_rng(seed).integers(0, VOCAB, size=size)


def test_single_request_greedy_matches_generate(lm):
    model = lm[2]
    eng = make_engine(model)
    prompt = prompts(1, 5)
    req = eng.submit(prompt, 20)
    eng.run_until_idle()
    assert req.done and len(req.tokens) == 20
    assert req.tokens == ref_tokens(model, prompt, 20)


def test_greedy_requests_equal_the_jax_engine(lm):
    jlm, params, model = lm
    reqs = [(prompts(s, int(n)), m) for s, n, m in ((2, 6, 21), (3, 3, 9), (4, 9, 13))]
    jeng = JEngine(jlm, params, slots=3, cache_size=96, decode_block=4, prefill_bucket=8)
    eng = make_engine(model)
    jh = [jeng.submit(p, n) for p, n in reqs]
    th = [eng.submit(p, n) for p, n in reqs]
    jeng.run_until_idle()
    eng.run_until_idle()
    for (p, _), a, b in zip(reqs, jh, th):
        seq = np.concatenate([p, a.tokens])[None].astype(np.int32)
        logits = np.asarray(jlm.apply({"params": params}, seq))[0, len(p) - 1:-1]
        top2 = np.sort(logits, -1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) >= MARGIN
        assert b.tokens == a.tokens


def test_mixed_arrival_parity_and_midflight_admission(lm):
    model = lm[2]
    eng = make_engine(model)
    pa, pb, pc = prompts(2, 6), prompts(3, 3), prompts(4, 9)
    ra = eng.submit(pa, 30)
    eng.step()
    eng.step()
    assert not ra.done and len(ra.tokens) > 1
    rb = eng.submit(pb, 9)
    rc = eng.submit(pc, 17)
    eng.run_until_idle()
    assert rb.active_at_admit >= 1
    for req, prompt, n in ((ra, pa, 30), (rb, pb, 9), (rc, pc, 17)):
        assert req.done and len(req.tokens) == n
        assert req.tokens == ref_tokens(model, prompt, n)


def test_sampled_requests_match_generate_whatever_the_arrival_order(lm):
    model = lm[2]
    reqs = [(prompts(10 + i, 3 + i), 10 + 3 * i,
             dict(temperature=0.8, top_k=7, top_p=0.9, seed=11 + i) if i % 2 else {})
            for i in range(4)]
    outs = []
    for order in (range(4), reversed(range(4))):
        eng = make_engine(model)
        handles = {}
        for i in order:
            prompt, n, kw = reqs[i]
            handles[i] = eng.submit(prompt, n, **kw)
            eng.step()  # interleave admission with decode
        eng.run_until_idle()
        outs.append({i: handles[i].tokens for i in range(4)})
    assert outs[0] == outs[1]
    for i, (prompt, n, kw) in enumerate(reqs):
        assert outs[0][i] == ref_tokens(model, prompt, n, **kw), i


def test_prefill_bucketing_is_exact(lm):
    model = lm[2]
    prompt = prompts(6, 5)
    outs = []
    for bucket in (1, 8):
        eng = make_engine(model, prefill_bucket=bucket)
        req = eng.submit(prompt, 13)
        eng.run_until_idle()
        outs.append(req.tokens)
    assert outs[0] == outs[1] == ref_tokens(model, prompt, 13)


def test_single_token_prompt_pads_past_decode_discriminator(lm):
    model = lm[2]
    eng = make_engine(model, prefill_bucket=1)
    assert eng._bucket_len(1) == 2
    req = eng.submit(np.asarray([7]), 14)
    eng.run_until_idle()
    assert req.tokens == ref_tokens(model, [7], 14)
    with pytest.raises(ValueError, match="length >= 2"):
        eng.pool.admit(0, np.asarray([7]), 1)


def test_kv_quant_pool_deterministic_and_first_token_exact(lm):
    model = lm[2]
    prompt = prompts(7, 6)
    outs = []
    for quant in (True, True, False):
        eng = make_engine(model, kv_quant=quant)
        req = eng.submit(prompt, 15)
        eng.run_until_idle()
        outs.append(req.tokens)
    assert outs[0] == outs[1] and len(outs[0]) == 15
    assert all(0 <= t < VOCAB for t in outs[0])
    assert outs[0][0] == outs[2][0]


def test_queue_backpressure_raises(lm):
    eng = make_engine(lm[2], slots=1, max_queue=2)
    eng.submit(np.arange(4), 6)
    eng.submit(np.arange(4), 6)
    with pytest.raises(QueueFullError):
        eng.submit(np.arange(4), 6)
    eng.run_until_idle()
    summary = eng.slo_summary()
    assert summary["rejected"] == 1 and summary["completed"] == 2


def test_submit_rejects_oversized_request(lm):
    eng = make_engine(lm[2], cache_size=32)
    with pytest.raises(ValueError, match="cache rows"):
        eng.submit(np.arange(4), 40)
    with pytest.raises(ValueError):
        eng.submit(np.arange(4), 0)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros(0), 4)


def test_cancel_queued_and_active(lm):
    eng = make_engine(lm[2], slots=1)
    ra = eng.submit(np.arange(5), 25)
    rb = eng.submit(np.arange(3), 10)
    eng.step()
    assert eng.cancel(rb.request_id)
    eng.step()
    assert eng.cancel(ra.request_id)
    eng.run_until_idle()
    assert ra.done and ra.cancelled and len(ra.tokens) < 25
    assert rb.done and rb.cancelled and rb.tokens == []
    assert not eng.cancel(12345)


def test_eos_token_truncates_stream(lm):
    model = lm[2]
    prompt = prompts(8, 5)
    full = ref_tokens(model, prompt, 20)
    eos = full[4]
    eng = make_engine(model)
    req = eng.submit(prompt, 20, eos_token=eos)
    eng.run_until_idle()
    assert req.tokens == full[: full.index(eos) + 1]


def test_max_new_tokens_one_completes_at_admission(lm):
    model = lm[2]
    prompt = prompts(9, 6)
    eng = make_engine(model)
    req = eng.submit(prompt, 1)
    eng.run_until_idle()
    assert req.done and req.tokens == ref_tokens(model, prompt, 1)
    assert eng.pool.live_lengths().max() == 0


def test_slot_reuse_after_completion_is_clean(lm):
    model = lm[2]
    p2 = prompts(11, 4)
    for quant in (False, True):
        fresh = make_engine(model, slots=1, kv_quant=quant)
        want = fresh.submit(p2, 16)
        fresh.run_until_idle()
        eng = make_engine(model, slots=1, kv_quant=quant)
        eng.submit(prompts(10, 7), 12)
        eng.run_until_idle()
        req = eng.submit(p2, 16)  # reuses the single slot
        eng.run_until_idle()
        assert req.tokens == want.tokens, quant
        if not quant:
            assert req.tokens == ref_tokens(model, p2, 16)


def test_slo_summary_reports_percentiles(lm):
    eng = make_engine(lm[2])
    for seed in range(3):
        eng.submit(prompts(seed, 4), 9)
    eng.run_until_idle()
    s = eng.slo_summary()
    assert s["completed"] == 3
    assert set(s["ttft_ms"]) >= {"count", "mean", "p50", "p90", "p99", "max"}
    assert s["ttft_ms"]["count"] == 3
    assert s["tpot_ms"]["count"] == 3 and s["tpot_ms"]["p50"] > 0
    assert 0 < s["slot_occupancy"] <= 1 and s["queue_depth"]["max"] >= 0
    assert s["decode_block"]["steps"] >= 1
    eng.reset_metrics()
    assert eng.slo_summary()["ttft_ms"] is None


def test_live_lengths_and_kv_lane_track_slot_progress(lm):
    eng = make_engine(lm[2])
    req = eng.submit(np.arange(1, 6), 20)
    eng.step()
    lens = eng.pool.live_lengths()
    assert lens.shape == (3,) and lens.max() == 5 + eng.pool.decode_block
    lane = eng.kv_lane(req.request_id)
    # floating leaves: per layer the big K/V and the rings, one slot's rows
    H, hd, C, T = 4, 8, 96, 4
    assert lane.dtype == np.float32 and lane.size == 2 * (2 * H * C * hd + 2 * H * T * hd)
    eng.run_until_idle()
    assert eng.pool.live_lengths().max() == 0
    assert eng.kv_lane(req.request_id) is None


def test_pool_guards_and_cache_helpers(lm):
    model = lm[2]
    with pytest.raises(ValueError, match="slot"):
        pool_mod.SlotKVPool(model, slots=0, cache_size=32)
    with pytest.raises(ValueError, match="decode_block"):
        pool_mod.SlotKVPool(model, slots=1, cache_size=32, decode_block=0)
    with pytest.raises(ValueError, match="max_len"):
        pool_mod.SlotKVPool(model, slots=1, cache_size=256)
    pool = pool_mod.SlotKVPool(model, slots=2, cache_size=32, decode_block=4, kv_quant=True)
    assert pool.cache["block_0"]["attn"]["cached_k"].dtype == torch.int8
    assert pool.cache["block_1"]["attn"]["cursor"].shape == (2,)
    assert pool.blocks_needed(9) == 2 and pool.capacity_needed(5, 8, 9) == 13
    tree = {"b": {"cursor": torch.tensor([3, 4], dtype=torch.int32)}, "a": {"x": torch.ones(1)}}
    assert pool_mod.find_cache_leaf(tree, "cursor").tolist() == [3, 4]
    out = pool_mod.replace_cache_leaves(tree, {"cursor": 7})
    assert out["b"]["cursor"].tolist() == [7, 7] and out["b"]["cursor"].dtype == torch.int32


def test_engine_rejects_the_flight_recorder(lm):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        make_engine(lm[2], recorder=object())
