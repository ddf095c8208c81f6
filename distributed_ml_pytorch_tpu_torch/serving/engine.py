"""Continuous-batching scheduler — the serving control plane (counterpart
of the JAX ``serving/engine.py``).

Many asynchronous clients feed one data plane, and all coordination is
host-side Python around the decode steps. The engine owns a
:class:`~distributed_ml_pytorch_tpu_torch.serving.cache.SlotKVPool` and runs
the classic continuous-batching loop:

1. **evict** — free the slots of finished/cancelled requests;
2. **admit** — pop queued requests into free slots (one prefill per
   request, bucketed prompt lengths), emitting each request's first token
   (TTFT ends here);
3. **decode** — one block advances every active slot by ``decode_block``
   tokens, however heterogeneous the batch is.

Admission only happens between decode blocks, so a request arriving while
others are mid-decode joins the very next block — no draining, no
restarts. Backpressure is explicit: ``submit`` raises
:class:`QueueFullError` once ``max_queue`` requests are waiting, which the
transport frontend maps to a reject frame (``serving/frontend.py``).

SLO observability rides ``utils/metrics.py``/``utils/tracing.py``: TTFT
and TPOT samples summarized by ``latency_summary`` percentiles, decode
block latency through a ``StepTimer``, queue depth and slot occupancy
sampled every scheduling round. Tokens stream at block granularity —
per-token latency is the block time divided by the block's tokens.

Determinism contract: with ``temperature=0`` (or any fixed sampling params
and seed) a request's output is the same regardless of arrival order or
what shares the batch, and token-identical on the CPU to
``generate(model, prompt[None], max_new_tokens, seed=seed)`` — slots are
independent rows of the same attention module, and token ``g`` is drawn
from the generator of ``(seed, g)``. On the card, cuBLAS may pick another
reduction order for another batch shape, so a greedy stream can part from
``generate()``'s after a near-tie of the logits.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.models.generate import DECODE_BLOCK
from distributed_ml_pytorch_tpu_torch.serving.cache import SlotKVPool
from distributed_ml_pytorch_tpu_torch.utils import obs
from distributed_ml_pytorch_tpu_torch.utils.metrics import latency_summary
from distributed_ml_pytorch_tpu_torch.utils.tracing import StepTimer


class QueueFullError(RuntimeError):
    """Raised by :meth:`ServingEngine.submit` when the wait queue is at
    ``max_queue`` — the engine's backpressure signal."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs, same semantics as ``generate()``:
    ``temperature <= 0`` is greedy (k/p/seed ignored); otherwise categorical
    at the given temperature with optional top-k / nucleus truncation, token
    ``g`` drawn from the generator of ``(seed, g)``."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


@dataclasses.dataclass
class Request:
    """One inference request and its whole lifecycle (the engine mutates it
    in place; ``wait()`` blocks until completion)."""

    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    sampling: SamplingParams
    eos_token: Optional[int] = None
    #: correlation id, minted at submit (or adopted from the submitting
    #: thread), so one request's journey is one id
    corr: int = 0
    #: sampling-schedule offset: this request's token ``g`` is drawn from the
    #: generator of ``(seed, gen_offset + g)`` — nonzero only for a resumed
    #: request that continues a stream mid-way
    gen_offset: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    slot: Optional[int] = None
    #: number of other requests mid-flight when this one was admitted —
    #: the continuous-batching witness
    active_at_admit: int = 0
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    @property
    def ttft(self) -> Optional[float]:
        return (self.t_first_token - self.t_submit) if self.t_first_token else None

    @property
    def tpot(self) -> Optional[float]:
        """Mean seconds per token after the first (block-granular stream)."""
        if not self.t_done or len(self.tokens) < 2:
            return None
        return (self.t_done - self.t_first_token) / (len(self.tokens) - 1)


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple if multiple > 1 else n


class ServingEngine:
    """Slot-based continuous-batching engine over one ``TransformerLM``
    (its weights are the model's own; the pool casts them once).

    ``on_tokens(request, new_tokens, done)`` is invoked from the scheduling
    thread every time a request's stream advances (admission's first token,
    then each decode block's truncated share) — the transport frontend
    hangs its send path on it. ``recorder`` (an optional
    ``utils/obs.SpanRecorder``) takes the serving plane's side of a fleet
    timeline: submit and queue-reject events, and the prefill and decode
    block spans, under each request's correlation id. It only observes.
    """

    def __init__(self, model, *, slots: int = 4,
                 cache_size: int = 256, decode_block: int = DECODE_BLOCK,
                 kv_quant: bool = False, max_queue: int = 64,
                 prefill_bucket: int = 16,
                 on_tokens: Optional[Callable] = None,
                 recorder=None):
        self.pool = SlotKVPool(
            model, slots=slots, cache_size=cache_size,
            decode_block=decode_block, kv_quant=kv_quant)
        self.max_queue = int(max_queue)
        self.prefill_bucket = max(1, int(prefill_bucket))
        self.on_tokens = on_tokens
        self.recorder = recorder
        self._lock = threading.Lock()
        self._queue: Deque[Request] = collections.deque()
        self._ids = itertools.count()
        S = self.pool.slots
        self._slot_req: List[Optional[Request]] = [None] * S
        # per-slot sampling state, passed to every decode block
        self._tok = np.zeros(S, np.int32)
        self._n_gen = np.zeros(S, np.int32)
        self._seeds = np.zeros(S, np.uint32)
        self._temps = np.zeros(S, np.float32)
        self._top_ks = np.zeros(S, np.int32)
        self._top_ps = np.ones(S, np.float32)
        # SLO samples (seconds; summaries convert to ms). Health samples
        # are bounded deques so a long-lived server cannot grow them
        # without limit; latency samples are per-request (bounded by
        # traffic actually served) and kept whole for exact percentiles.
        self._ttft: List[float] = []
        self._tpot: List[float] = []
        self._queue_depths: collections.deque = collections.deque(maxlen=65536)
        self._occupancy: collections.deque = collections.deque(maxlen=65536)
        self._block_timer = StepTimer(skip=1)
        self._completed = 0
        self._cancelled = 0
        self._rejected = 0

    # ------------------------------------------------------------- submit
    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               seed: int = 0, eos_token: Optional[int] = None,
               request_id: Optional[int] = None,
               gen_offset: int = 0) -> Request:
        """Queue one request; returns its live :class:`Request` handle.

        ``gen_offset`` resumes the sampling-key schedule at that generated-
        token index — the stream-migration path passes the number of tokens
        already emitted by a dead engine, with ``prompt`` extended by those
        tokens and ``max_new_tokens`` reduced by the same count, and the
        resumed stream continues token-identically.

        Raises :class:`QueueFullError` at ``max_queue`` waiting requests
        (admission control) and ``ValueError`` for requests the pool can
        never hold (those would wedge the queue forever).
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        bucket = self._bucket_len(int(prompt.size))
        need = self.pool.capacity_needed(int(prompt.size), bucket,
                                         int(max_new_tokens))
        if need > self.pool.cache_size:
            raise ValueError(
                f"request needs {need} cache rows (prompt {prompt.size} "
                f"-> bucket {bucket}, {max_new_tokens} new tokens in "
                f"{self.pool.decode_block}-token blocks) but slots hold "
                f"{self.pool.cache_size}")
        req = Request(
            request_id=(request_id if request_id is not None
                        else next(self._ids)),
            prompt=prompt, max_new_tokens=int(max_new_tokens),
            sampling=SamplingParams(temperature, top_k, top_p, seed),
            eos_token=eos_token, gen_offset=max(0, int(gen_offset)),
            # adopt the submitting thread's active correlation id (a
            # frontend relaying an enveloped SubmitRequest, or a migration
            # resubmit) — mint a fresh one only at a true origin
            corr=obs.current_corr() or obs.next_corr(),
            t_submit=time.perf_counter())
        with self._lock:
            # cancelled entries (e.g. overload-shed work awaiting its
            # admission-pass drop) no longer hold queue room — a displacing
            # submit must be admittable the moment its victim is shed
            if sum(1 for r in self._queue
                   if not r.cancelled) >= self.max_queue:
                self._rejected += 1
                if self.recorder is not None:
                    self.recorder.event("queue-reject", corr=req.corr, id=req.request_id)
                raise QueueFullError(
                    f"queue at max_queue={self.max_queue}; retry later")
            self._queue.append(req)
        if self.recorder is not None:
            self.recorder.event("submit", corr=req.corr, id=req.request_id,
                                prompt_len=int(prompt.size))
        return req

    def _bucket_len(self, prompt_len: int) -> int:
        """Padded prefill length for a prompt. Never 1: inside the blocked
        decode module ``s == 1`` is the branch discriminator for a DECODE
        step (the same hazard ``uses_block_decode`` guards in generate()),
        so a 1-token prompt pads to 2 even at prefill_bucket=1."""
        return max(2, _round_up(prompt_len, self.prefill_bucket))

    def cancel(self, request_id: int) -> bool:
        """Flag a request cancelled. Queued requests are dropped at the next
        admission pass; an active request's slot is evicted at the next
        block boundary. Returns whether the id was found live."""
        with self._lock:
            for req in self._queue:
                if req.request_id == request_id and not req.done:
                    req.cancelled = True
                    return True
        for req in self._slot_req:
            if req is not None and req.request_id == request_id:
                req.cancelled = True
                return True
        return False

    def kv_lane(self, request_id: int) -> Optional[np.ndarray]:
        """The flat KV-cache lane behind a live request's slot, or None
        when the request holds no slot (queued / finished)."""
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.request_id == request_id:
                return self.pool.slot_kv(slot)
        return None

    # ------------------------------------------------------------ schedule
    def step(self) -> bool:
        """One scheduling round: evict → admit → decode one block. Returns
        False when there was nothing to do (caller may idle-sleep)."""
        worked = self._evict()
        worked = self._admit() or worked
        active = [r is not None for r in self._slot_req]
        if worked or any(active):
            # sample scheduler health only on rounds that do work — a
            # serve_forever loop idles at ~500 rounds/s and would both
            # grow these lists without bound and dilute the occupancy
            # stats with idle zeros (the deques bound the busy case too)
            with self._lock:
                self._queue_depths.append(len(self._queue))
            self._occupancy.append(sum(active) / len(active))
        if any(active):
            self._decode(np.asarray(active, bool))
            worked = True
        return worked

    def run_until_idle(self, max_rounds: int = 10_000) -> None:
        """Drive scheduling rounds until queue and slots are empty (the
        synchronous harness of the tests and ``chip_smoke.py``)."""
        for _ in range(max_rounds):
            if not self.step():
                with self._lock:
                    queued = len(self._queue)
                if queued == 0 and not any(
                        r is not None for r in self._slot_req):
                    return
        raise RuntimeError(f"not idle after {max_rounds} scheduling rounds")

    def _evict(self) -> bool:
        freed = []
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            if req.done or req.cancelled:
                self._finish(req)
                self._slot_req[slot] = None
                freed.append(slot)
        if freed:
            self.pool.reset_slots(freed)
        return bool(freed)

    def _admit(self) -> bool:
        admitted = False
        free = [s for s, r in enumerate(self._slot_req) if r is None]
        while free:
            with self._lock:
                while self._queue and self._queue[0].cancelled:
                    self._finish(self._queue.popleft())
                if not self._queue:
                    break
                req = self._queue.popleft()
            slot = free.pop(0)
            p = int(req.prompt.size)
            bucket = self._bucket_len(p)
            padded = np.zeros(bucket, np.int32)
            padded[:p] = req.prompt
            sp = req.sampling
            # claim the slot before the prefill: between the queue pop above
            # and this point the request is in neither the queue count nor
            # the slot count, and a pressure() sample from another thread
            # would see a falsely idle engine
            req.active_at_admit = sum(
                r is not None for r in self._slot_req)
            req.slot = slot  # with it, "slot is None" == waiting, exactly
            self._slot_req[slot] = req
            rec = self.recorder
            t0 = time.monotonic_ns() if rec is not None else 0
            tok0 = self.pool.admit(
                slot, padded, p, seed=sp.seed, temperature=sp.temperature,
                top_k=sp.top_k, top_p=sp.top_p, gen_offset=req.gen_offset)
            req.t_admit = time.perf_counter()
            if rec is not None:
                # the queue wait ended here: the prefill span carries the
                # request's correlation id through its admission
                rec.record("prefill", "prefill", t0, time.monotonic_ns(), corr=req.corr,
                           meta={"id": req.request_id, "slot": slot, "bucket": bucket})
            self._tok[slot] = tok0
            # the per-slot sampling clock continues the request's own
            # schedule: a resumed request's next draw is token gen_offset + 1
            self._n_gen[slot] = req.gen_offset + 1
            self._seeds[slot] = np.uint32(sp.seed)
            self._temps[slot] = sp.temperature
            self._top_ks[slot] = sp.top_k
            self._top_ps[slot] = sp.top_p
            self._emit(req, [tok0])
            admitted = True
            if req.done:  # max_new_tokens == 1, or the first token was eos
                self._finish(req)
                self._slot_req[slot] = None
                self.pool.reset_slots([slot])  # same sweep _evict gives others
                free.insert(0, slot)
        return admitted

    def _decode(self, active: np.ndarray) -> None:
        rec = self.recorder
        t0 = time.monotonic_ns() if rec is not None else 0
        self._block_timer.start()
        toks = self.pool.decode_block_step(
            self._tok, self._n_gen, self._seeds, self._temps,
            self._top_ks, self._top_ps, active)  # [S, T] host array (syncs)
        self._block_timer.tick()
        if rec is not None:
            rec.record("decode-block", "decode", t0, time.monotonic_ns(), corr=0,
                       meta={"active": int(active.sum())})
        T = toks.shape[1]
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._tok[slot] = toks[slot, -1]
            self._n_gen[slot] += T  # sampling-step clock, even past finish
            remaining = req.max_new_tokens - len(req.tokens)
            self._emit(req, toks[slot, :remaining].tolist())

    def _emit(self, req: Request, new_tokens: List[int]) -> None:
        """Append ``new_tokens`` to a request's stream (truncating at eos),
        stamp TTFT/finish times, and fan out to ``on_tokens``."""
        if req.eos_token is not None and new_tokens:
            for i, t in enumerate(new_tokens):
                if t == req.eos_token:
                    new_tokens = new_tokens[: i + 1]
                    req.done = True
                    break
        req.tokens.extend(int(t) for t in new_tokens)
        now = time.perf_counter()
        if not req.t_first_token and req.tokens:
            req.t_first_token = now
            self._ttft.append(req.ttft)
        if len(req.tokens) >= req.max_new_tokens:
            req.done = True
        if req.done:
            req.t_done = now
            self._record_done(req)
        if self.on_tokens is not None and new_tokens:
            self.on_tokens(req, [int(t) for t in new_tokens], req.done)

    def _record_done(self, req: Request) -> None:
        """SLO accounting at the moment a stream closes (NOT at eviction —
        the last request's samples must exist before its slot is swept).
        Cancellations count separately: "completed" means served in full."""
        if req.cancelled:
            self._cancelled += 1
            return
        self._completed += 1
        if req.tpot is not None:
            self._tpot.append(req.tpot)

    def _finish(self, req: Request) -> None:
        if req.cancelled and not req.done:
            req.done = True
            req.t_done = time.perf_counter()
            self._record_done(req)
            if self.on_tokens is not None:
                self.on_tokens(req, [], True)
        req._event.set()

    # ------------------------------------------------------------- metrics
    def pressure(self) -> Tuple[int, int, int]:
        """Cheap load sample for admission control: ``(busy_slots,
        total_slots, queued)``. Advisory — one scheduling round stale at
        worst (shed decisions are rate signals, not invariants)."""
        with self._lock:
            queued = len(self._queue)
        busy = sum(r is not None for r in self._slot_req)
        return busy, self.pool.slots, queued

    def recent_ttft_ms(self, k: int = 16) -> float:
        """Mean of the last ``k`` TTFT samples in milliseconds (0.0 when
        nothing completed yet) — the overload plane's SLO-breach signal."""
        tail = self._ttft[-k:]
        if not tail:
            return 0.0
        return float(np.mean(tail)) * 1e3

    def reset_metrics(self) -> None:
        """Drop accumulated SLO samples (e.g. after a warmup) while
        keeping the block timer's warmup state — mirrors
        ``StepTimer.reset_stats``."""
        self._ttft.clear()
        self._tpot.clear()
        self._queue_depths.clear()
        self._occupancy.clear()
        self._block_timer.reset_stats()
        self._completed = 0
        self._cancelled = 0
        self._rejected = 0

    def slo_summary(self) -> dict:
        """Percentile SLO report (milliseconds) over everything completed so
        far, plus scheduler health (queue depth, occupancy, rejects)."""
        to_ms = lambda xs: [x * 1e3 for x in xs]
        depths = self._queue_depths or [0]
        return {
            "completed": self._completed,
            "cancelled": self._cancelled,
            "rejected": self._rejected,
            "ttft_ms": latency_summary(to_ms(self._ttft)),
            "tpot_ms": latency_summary(to_ms(self._tpot)),
            "decode_block": self._block_timer.summary(),
            "queue_depth": {"mean": float(np.mean(depths)),
                            "max": int(np.max(depths))},
            "slot_occupancy": float(np.mean(self._occupancy or [0.0])),
        }
