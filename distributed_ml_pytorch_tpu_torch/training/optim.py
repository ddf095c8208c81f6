"""The optimizer layer of the port (counterpart of the optax chain that the
JAX ``training/trainer.py`` assembles in ``make_lr_schedule``,
``make_optimizer`` and ``build_tx``).

Every optimizer keeps the port's contract: ``init(params) -> state`` and
``update(grads, state[, params]) -> updates``, the state advanced in place,
the parameters then moved by ``params += updates``. The state is an
:class:`OptState` of tensors on the parameters' device, its step count
included, so a step reads the learning rate at step t, Adam's bias
correction and the accumulation counter from device tensors, syncs with the
host nowhere and can be captured in a CUDA graph and replayed.

The arithmetic is optax's, operation for operation:

- ``sgd``: ``trace = g + momentum·trace`` when momentum is set, then
  ``updates = −lr·trace`` (``optax.sgd``);
- ``adam``/``adamw``: ``mu = (1−b1)·g + b1·mu``, ``nu = (1−b2)·g² + b2·nu``,
  both bias-corrected by ``1 − b**(count+1)``, ``u = mu_hat / (sqrt(nu_hat) +
  eps)`` with b1 0.9, b2 0.999, eps 1e-8 (``optax.scale_by_adam``); adamw
  adds ``weight_decay·params`` to ``u`` (decoupled), 1e-4 unless given;
- global-norm clipping first, ``where(norm < max, g, (g / norm)·max)``;
- L2 weight decay for sgd and adam, ``g + weight_decay·params``, after the
  clipping and before the update rule;
- :class:`MultiSteps`: ``optax.MultiSteps`` with the mean — Welford's
  running mean ``acc + (g − acc)/(n + 1)``, zero updates on the non-final
  micro-steps, and the inner state (its count, so its schedule) committed
  only on the final one.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: optax.adamw's default decoupled weight decay
ADAMW_DEFAULT_DECAY = 1e-4

Schedule = Callable[[torch.Tensor], torch.Tensor]


# ------------------------------------------------------------------ schedules

class InverseEpochSchedule:
    """``lr / (count // steps_per_epoch + 1)``: the reference's configured
    1/(epoch+1) decay, applied."""

    def __init__(self, lr: float, steps_per_epoch: int):
        self.lr = float(lr)
        self.steps_per_epoch = max(1, int(steps_per_epoch))

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        denom = torch.div(count, self.steps_per_epoch, rounding_mode="floor") + 1
        # one float32 division, as jnp's lr / int32 array (a Python float
        # over a tensor would go through a reciprocal)
        return torch.full((), self.lr, dtype=torch.float32, device=count.device) / denom


class CosineSchedule:
    """``optax.cosine_decay_schedule(lr, decay_steps)`` (alpha 0):
    ``lr · 0.5·(1 + cos(π·min(count, T)/T))``."""

    def __init__(self, lr: float, decay_steps: int):
        if not decay_steps > 0:
            raise ValueError(f"cosine schedule needs positive decay_steps, got {decay_steps}")
        self.lr = float(lr)
        self.decay_steps = float(decay_steps)

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count.to(torch.float32), max=self.decay_steps)
        return self.lr * (0.5 * (1 + torch.cos(math.pi * c / self.decay_steps)))


def make_lr_schedule(kind: str, lr: float, steps_per_epoch: int = 1,
                     total_epochs: int = 1) -> Union[float, Schedule]:
    """The ``--lr-schedule`` choices: ``constant`` (a float), ``inverse-epoch``
    and ``cosine`` (cosine decay to 0 over ``steps_per_epoch · total_epochs``
    updates), each a function of the update count tensor."""
    if kind == "constant":
        return lr
    if kind == "inverse-epoch":
        return InverseEpochSchedule(lr, steps_per_epoch)
    if kind == "cosine":
        return CosineSchedule(lr, max(1, int(steps_per_epoch) * int(total_epochs)))
    raise ValueError(f"unknown lr schedule {kind!r} (constant|inverse-epoch|cosine)")


def lr_at(lr: Union[float, Schedule], count: torch.Tensor):
    """The learning rate at ``count``: a float stays a float (no device op)."""
    return lr(count) if callable(lr) else lr


# ------------------------------------------------------------------ state

class OptState:
    """An optimizer's state, every tensor on the parameters' device.

    ``count`` is the 0-d int32 update count (``MultiSteps``: the gradient
    step); ``slots`` maps a name to one tensor per parameter (``trace``,
    ``mu``, ``nu``, ``acc``); ``mini_step`` and ``inner`` are
    :class:`MultiSteps`'s micro-step counter and its wrapped optimizer's
    state. ``len()`` is the number of per-parameter slots (0 for plain SGD).
    """

    def __init__(self, count: torch.Tensor, slots: Optional[Dict[str, List[torch.Tensor]]] = None,
                 mini_step: Optional[torch.Tensor] = None, inner: Optional["OptState"] = None):
        self.count = count
        self.slots = slots or {}
        self.mini_step = mini_step
        self.inner = inner

    def __len__(self) -> int:
        return len(next(iter(self.slots.values()), []))

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state, in a fixed order."""
        out = [self.count] + ([self.mini_step] if self.mini_step is not None else [])
        for name in sorted(self.slots):
            out += self.slots[name]
        return out + (self.inner.tensors() if self.inner is not None else [])

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "slots": {k: list(v) for k, v in self.slots.items()},
                "inner": None if self.inner is None else self.inner.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Copy ``sd`` into this state's tensors in place (their storage, and
        so any CUDA graph captured over them, stays valid)."""
        mine, theirs = self.tensors(), OptState._from_dict(sd).tensors()
        if len(mine) != len(theirs) or any(a.shape != b.shape for a, b in zip(mine, theirs)):
            raise ValueError("optimizer state does not match this optimizer's layout")
        with torch.no_grad():
            for a, b in zip(mine, theirs):
                a.copy_(b)

    @staticmethod
    def _from_dict(sd: dict) -> "OptState":
        return OptState(sd["count"], sd["slots"], sd["mini_step"],
                        None if sd["inner"] is None else OptState._from_dict(sd["inner"]))


def _zeros(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params]


def _count(params: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


# ------------------------------------------------------------------ optimizers

def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        sq_norm: Optional[Callable] = None) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: no host synchronisation (the choice is
    a ``where`` on the card). ``sq_norm(grads)`` replaces the local sum of
    squares where the gradients are shards of a larger set
    (``parallel/fsdp.py``)."""
    norm = torch.sqrt(sq_norm(grads) if sq_norm is not None
                      else sum(torch.sum(g * g) for g in grads))
    trigger = norm < max_norm
    return [torch.where(trigger, g, (g / norm) * max_norm) for g in grads]


class Optimizer:
    """One of ``sgd`` (momentum optional), ``adam`` or ``adamw`` with its
    optional clipping and weight decay, as the optax chain
    ``make_optimizer`` builds. ``lr`` is a float or a schedule of the count."""

    def __init__(self, name: str, lr, momentum: float = 0.0,
                 weight_decay: Optional[float] = None, grad_clip: float = 0.0):
        name = name.lower()
        if name not in ("sgd", "adam", "adamw"):
            raise ValueError(f"unknown optimizer {name!r} (sgd|adam|adamw)")
        if not callable(lr) and lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        self.name = name
        self.lr = lr
        self.momentum = float(momentum or 0.0) if name == "sgd" else 0.0
        self.grad_clip = float(grad_clip or 0.0)
        # L2 folded into the gradient for sgd/adam; decoupled for adamw,
        # whose None keeps optax's default and 0.0 turns decay off
        self.l2 = float(weight_decay) if weight_decay and name != "adamw" else 0.0
        self.decoupled = ((ADAMW_DEFAULT_DECAY if weight_decay is None else float(weight_decay))
                          if name == "adamw" else 0.0)
        #: the squared global norm of the gradients for clipping (None: the
        #: local sum; a sharded step sets its reduction over the ranks)
        self.sq_norm: Optional[Callable] = None

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        params = list(params)
        slots = {}
        if self.momentum:
            slots["trace"] = _zeros(params)
        if self.name != "sgd":
            slots["mu"], slots["nu"] = _zeros(params), _zeros(params)
        return OptState(_count(params), slots)

    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
        """The updates for ``grads``; advances ``state`` in place."""
        if (self.l2 or self.decoupled) and params is None:
            raise ValueError(f"{self.name} with weight decay needs the parameters")
        with torch.no_grad():
            g = list(grads)
            if self.grad_clip > 0:
                g = clip_by_global_norm(g, self.grad_clip, self.sq_norm)
            if self.l2:
                g = [gi + self.l2 * p for gi, p in zip(g, params)]
            if self.name == "sgd":
                if self.momentum:
                    for t, gi in zip(state.slots["trace"], g):
                        t.mul_(self.momentum).add_(gi)
                    g = state.slots["trace"]
            else:
                g = self._adam(g, state)
                if self.decoupled:
                    g = [u + self.decoupled * p for u, p in zip(g, params)]
            lr = lr_at(self.lr, state.count)
            updates = [u * (-lr) for u in g]
            state.count.add_(1)
        return updates

    @staticmethod
    def _adam(g: List[torch.Tensor], state: OptState) -> List[torch.Tensor]:
        b1, b2 = ADAM_B1, ADAM_B2
        count = (state.count + 1).to(torch.float32)
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        out = []
        for gi, mu, nu in zip(g, state.slots["mu"], state.slots["nu"]):
            mu.copy_((1 - b1) * gi + b1 * mu)
            nu.copy_((1 - b2) * (gi * gi) + b2 * nu)
            out.append((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
        return out


class SGD(Optimizer):
    """Plain SGD with optional momentum, as optax ``sgd(lr, momentum)``."""

    def __init__(self, lr, momentum: float = 0.0):
        super().__init__("sgd", lr, momentum)


class MultiSteps:
    """``optax.MultiSteps(opt, every_k_schedule=k)``: the gradients of ``k``
    consecutive micro-steps averaged (Welford's running mean) into one update
    of ``opt``. The inner update is computed every micro-step, as optax's
    is, and its state committed only when the micro-step is the k-th (a
    ``where`` on the card, not a host branch); the other micro-steps return
    zero updates."""

    def __init__(self, opt: Optimizer, every_k: int):
        if int(every_k) < 1:
            raise ValueError(f"every_k must be positive, got {every_k}")
        self.opt = opt
        self.every_k = int(every_k)

    @property
    def lr(self):
        return self.opt.lr

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        params = list(params)
        return OptState(_count(params), {"acc": _zeros(params)}, mini_step=_count(params),
                        inner=self.opt.init(params))

    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
        with torch.no_grad():
            n = state.mini_step
            acc = [a + (g - a) / (n + 1) for g, a in zip(grads, state.slots["acc"])]
            inner = state.inner.tensors()
            before = [t.clone() for t in inner]
            final = self.opt.update(acc, state.inner, params)
            emit = n == self.every_k - 1
            for t, old in zip(inner, before):
                t.copy_(torch.where(emit, t, old))
            keep = (~emit).to(torch.float32)
            for a_state, a in zip(state.slots["acc"], acc):
                a_state.copy_(keep * a)
            state.count.copy_(torch.where(emit, state.count + 1, state.count))
            n.copy_((n + 1) % self.every_k)
            return [emit * u for u in final]


# ------------------------------------------------------------------ assembly

def make_optimizer(name: str, lr, momentum: float = 0.0, weight_decay: Optional[float] = None,
                   grad_clip: float = 0.0) -> Optimizer:
    """The ``--optimizer`` registry: ``sgd`` (the reference's recipe),
    ``adam`` and ``adamw``, with optional global-norm clipping and weight
    decay (see :class:`Optimizer`)."""
    return Optimizer(name, lr, momentum, weight_decay, grad_clip)


def build_tx(optimizer: str, lr, momentum: float = 0.0, weight_decay: Optional[float] = None,
             grad_clip: float = 0.0, grad_accum: int = 1):
    """:func:`make_optimizer` wrapped in :class:`MultiSteps` when
    ``grad_accum > 1``: the one assembly point of the kwarg and CLI paths."""
    tx = make_optimizer(optimizer, lr, momentum, weight_decay, grad_clip)
    if int(grad_accum) > 1:
        tx = MultiSteps(tx, int(grad_accum))
    return tx


def with_sq_norm(tx, sq_norm: Callable):
    """``tx`` (an :class:`Optimizer` or a :class:`MultiSteps` of one) whose
    global-norm clipping takes the squared norm from ``sq_norm(grads)``: a
    shallow copy, ``tx`` itself unchanged; ``tx`` when it does not clip."""
    inner = getattr(tx, "opt", tx)
    if not inner.grad_clip:
        return tx
    inner = copy.copy(inner)
    inner.sq_norm = sq_norm
    if not isinstance(tx, MultiSteps):
        return inner
    outer = copy.copy(tx)
    outer.opt = inner
    return outer


def tx_from_args(args, steps_per_epoch: int = 1):
    """The optimizer from the CLI surface, shared by the single-process
    trainer and the DownPour worker. ``steps_per_epoch`` is in raw batches;
    with ``--grad-accum K`` the schedule's epoch counts optimizer updates
    (raw batches // K), as ``optax.MultiSteps`` emits one update per K."""
    grad_accum = int(getattr(args, "grad_accum", 1) or 1)
    lr = make_lr_schedule(getattr(args, "lr_schedule", "constant"), args.lr,
                          steps_per_epoch=max(1, int(steps_per_epoch) // grad_accum),
                          total_epochs=getattr(args, "epochs", 1))
    return build_tx(getattr(args, "optimizer", "sgd"), lr, getattr(args, "momentum", 0.0),
                    getattr(args, "weight_decay", None), getattr(args, "grad_clip", 0.0),
                    grad_accum)
