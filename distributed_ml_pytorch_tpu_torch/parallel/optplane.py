"""The server-side optimizer plane: a sharded optimizer state and Adasum
(counterpart of the JAX ``parallel/optplane.py``; numpy only, so both
packages step the same bits).

**Sharded optimizer** (:class:`ShardedOptimizer`, after "Automatic
Cross-Replica Sharding of Weight Update in Data-Parallel Training",
arXiv:2004.13336). Each server owns the optimizer state of exactly the
contiguous ``[lo, hi)`` range it serves, and turns each admitted, combined
update ``u`` into the delta it applies:

- ``sgdm`` — heavy ball over the incoming deltas: ``m = momentum * m + u``,
  ``delta = lr * m``;
- ``adam`` — Adam moments of ``u`` with bias correction, ``delta = lr *
  m_hat / (sqrt(v_hat) + eps)``.

The maths is elementwise, so a step over ``[lo, hi)`` equals that slice of
a dense step.

**Durability.** The WAL logs the optimizer's input (the combined delta) and
replay re-runs :meth:`ShardedOptimizer.step`, so checkpoint plus replay
rebuilds the vector and the optimizer state bit for bit. The state itself
rides the checkpoint (:meth:`~ShardedOptimizer.save_state`): a
two-generation ``ps_opt.npz`` written before the checkpoint's meta, each
generation bound to its central vector by the vector's CRC, so a crash
between the checkpoint's renames resolves to a vector and an optimizer state
of one generation.

**Adasum** (:func:`adasum`, "Scaling Distributed Training with Adaptive
Summation", arXiv:2006.02924)::

    Adasum(a, b) = (1 - a.b / 2|a|^2) a + (1 - a.b / 2|b|^2) b

the plain sum for orthogonal updates, ``a`` for identical ones. The server
keeps, per worker, the overlap (the deltas applied since that worker's last
pull) and applies ``Adasum(overlap, push) - overlap``, so a push that
repeats what others applied moves the parameters once. Anti-aligned inputs
(``a.b < 0``) take the plain sum, as in the JAX package: only redundancy is
damped.
"""

from __future__ import annotations

import io
import os
from typing import Dict, Optional

import numpy as np

from distributed_ml_pytorch_tpu_torch.utils.durability import atomic_write

#: the server-side optimizer kinds of ``--server-opt``
OPT_KINDS = ("sgdm", "adam")


def adasum(a: np.ndarray, b: np.ndarray, *, eps: float = 1e-30) -> np.ndarray:
    """Adasum of two updates, its dot products in float64; float32 out."""
    a64 = np.asarray(a, np.float64).ravel()
    b64 = np.asarray(b, np.float64).ravel()
    dot = float(a64 @ b64)
    na = float(a64 @ a64)
    nb = float(b64 @ b64)
    if dot <= 0.0 or na <= eps or nb <= eps:
        return (a64 + b64).astype(np.float32)
    return ((1.0 - dot / (2.0 * na)) * a64
            + (1.0 - dot / (2.0 * nb)) * b64).astype(np.float32)


def adasum_adjust(overlap: np.ndarray, push: np.ndarray, *, eps: float = 1e-30,
                  ) -> np.ndarray:
    """The increment that moves central parameters which already hold
    ``overlap`` onto ``Adasum(overlap, push)`` (``push`` when orthogonal):
    ``float32(float64(adasum(overlap, push)) - overlap)``, the JAX
    package's bits, with one float64 copy of each input and the merge done
    in place (the server runs it on every push of the whole vector)."""
    a64 = np.asarray(overlap, np.float64).ravel()
    b64 = np.array(push, np.float64).ravel()  # a copy: scaled in place below
    dot = float(a64 @ b64)
    na = float(a64 @ a64)
    nb = float(b64 @ b64)
    if dot <= 0.0 or na <= eps or nb <= eps:
        merged = a64 + b64
    else:
        merged = np.multiply(a64, 1.0 - dot / (2.0 * na))
        merged += np.multiply(b64, 1.0 - dot / (2.0 * nb), out=b64)
    np.copyto(merged, merged.astype(np.float32))  # adasum's float32 rounding
    merged -= a64
    return merged.astype(np.float32)


class ShardedOptimizer:
    """The optimizer state of one contiguous parameter range; :meth:`step`
    maps a combined update to the applied delta. Touched only by its
    server's serving thread and by replay before serving starts: no lock."""

    def __init__(self, kind: str, lo: int = 0, hi: int = 0, *, lr: float = 1.0,
                 momentum: float = 0.9, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8):
        if kind not in OPT_KINDS:
            raise ValueError(f"unknown optimizer kind {kind!r} (known: {OPT_KINDS})")
        self.kind = kind
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.eps = float(eps)
        self.lo = self.hi = 0
        self.t = 0  # Adam's bias-correction step count
        self.m = np.zeros(0, np.float32)
        self.v = np.zeros(0, np.float32)  # Adam's; kept for sgdm too
        self.resize(lo, hi)

    @property
    def size(self) -> int:
        return self.hi - self.lo

    def state_floats(self) -> int:
        """The state's footprint in float32 words."""
        return int(self.m.size + self.v.size)

    def step(self, u: np.ndarray) -> np.ndarray:
        """The applied delta of one update of ``hi - lo`` elements; the same
        inputs from the same state give the same deltas and state."""
        u = np.asarray(u, np.float32).ravel()
        if u.size != self.size:
            raise ValueError(f"update of {u.size} params for optimizer range "
                             f"[{self.lo},{self.hi})")
        if self.kind == "sgdm":
            self.m = (self.momentum * self.m + u).astype(np.float32)
            return (self.lr * self.m).astype(np.float32)
        self.t += 1
        self.m = (self.beta1 * self.m + (1.0 - self.beta1) * u).astype(np.float32)
        self.v = (self.beta2 * self.v + (1.0 - self.beta2) * (u * u)).astype(np.float32)
        mhat = self.m / np.float32(1.0 - self.beta1 ** self.t)
        vhat = self.v / np.float32(1.0 - self.beta2 ** self.t)
        return (np.float32(self.lr) * mhat
                / (np.sqrt(vhat) + np.float32(self.eps))).astype(np.float32)

    def reset(self) -> None:
        """Zero the moments: the state a restore adopts when no saved state
        pairs with its vector."""
        self.t = 0
        self.m = np.zeros(self.size, np.float32)
        self.v = np.zeros(self.size, np.float32)

    def resize(self, lo: int, hi: int) -> None:
        """Adopt a new range, keeping the state of its overlap with the old
        one; the newly acquired elements start at zero."""
        lo, hi = int(lo), int(hi)
        if (lo, hi) == (self.lo, self.hi):
            return
        if hi < lo:
            raise ValueError(f"bad optimizer range [{lo},{hi})")
        new_m = np.zeros(hi - lo, np.float32)
        new_v = np.zeros(hi - lo, np.float32)
        o_lo, o_hi = max(self.lo, lo), min(self.hi, hi)
        if o_lo < o_hi:
            new_m[o_lo - lo:o_hi - lo] = self.m[o_lo - self.lo:o_hi - self.lo]
            new_v[o_lo - lo:o_hi - lo] = self.v[o_lo - self.lo:o_hi - self.lo]
        self.lo, self.hi = lo, hi
        self.m, self.v = new_m, new_v

    # ------------------------------------------------------- persistence

    def state_dict(self) -> Dict:
        return {"kind": self.kind, "lo": self.lo, "hi": self.hi, "t": self.t,
                "m": self.m.copy(), "v": self.v.copy()}

    def load_state_dict(self, st: Dict) -> None:
        if st["hi"] - st["lo"] != self.size:
            raise ValueError(f"optimizer state for [{st['lo']},{st['hi']}) does not fit range "
                             f"[{self.lo},{self.hi})")
        self.t = int(st["t"])
        self.m = np.asarray(st["m"], np.float32).copy()
        self.v = np.asarray(st["v"], np.float32).copy()

    def save_state(self, path: str, *, central_crc: int, apply_seq: int,
                   prev_crc: Optional[int] = None) -> None:
        """Save this state as the ``cur`` generation of ``path``, bound to
        the central vector whose CRC is ``central_crc``, and keep one older
        generation as ``prev``: the stored generation whose CRC is
        ``prev_crc`` (the last completed checkpoint's vector), not blindly
        the stored ``cur``, which after a torn save is an orphan that no
        vector generation adopted. Called before the checkpoint's renames."""
        prev: Dict[str, np.ndarray] = {}
        if os.path.exists(path):
            try:
                with np.load(path) as old:
                    pick = None
                    for gen in ("cur", "prev"):
                        if f"{gen}_m" not in old:
                            continue
                        if prev_crc is None or int(old[f"{gen}_crc"]) == (
                                int(prev_crc) & 0xFFFFFFFF):
                            pick = gen
                            break
                    if pick is not None:
                        for key in ("m", "v", "t", "crc", "seq", "lo", "hi"):
                            if f"{pick}_{key}" in old:
                                prev[f"prev_{key}"] = old[f"{pick}_{key}"]
            except (OSError, ValueError):
                prev = {}  # an unreadable old file: one generation
        buf = io.BytesIO()
        np.savez(buf, cur_m=self.m, cur_v=self.v, cur_t=np.int64(self.t),
                 cur_crc=np.uint32(central_crc & 0xFFFFFFFF), cur_seq=np.int64(apply_seq),
                 cur_lo=np.int64(self.lo), cur_hi=np.int64(self.hi), **prev)
        atomic_write(path, buf.getvalue())

    def load_state(self, path: str, *, central_crc: Optional[int] = None) -> bool:
        """Adopt the stored generation whose CRC is ``central_crc`` (``None``:
        the current one). False when ``path`` does not exist; raises when it
        exists but no generation matches, since pairing momentum with another
        vector generation would misapply every replayed record."""
        if not os.path.exists(path):
            return False
        with np.load(path) as data:
            for gen in ("cur", "prev"):
                if f"{gen}_m" not in data:
                    continue
                crc = int(data[f"{gen}_crc"])
                if central_crc is not None and crc != (int(central_crc) & 0xFFFFFFFF):
                    continue
                lo = int(data[f"{gen}_lo"])
                hi = int(data[f"{gen}_hi"])
                if hi - lo != self.size:
                    raise ValueError(f"optimizer state at {path} covers [{lo},{hi}) but this "
                                     f"server's range is [{self.lo},{self.hi}) — state/map "
                                     "mismatch")
                self.t = int(data[f"{gen}_t"])
                self.m = np.asarray(data[f"{gen}_m"], np.float32).copy()
                self.v = np.asarray(data[f"{gen}_v"], np.float32).copy()
                return True
        raise ValueError(f"optimizer state at {path} matches neither stored generation "
                         "against the restored central vector's CRC — refusing to pair "
                         "momentum with the wrong vector generation")


def server_opt_from_args(args):
    """``--server-opt``/``--server-lr``/``--server-momentum`` as ``(kind or
    None, kwargs)``."""
    kind = getattr(args, "server_opt", "") or ""
    if not kind or kind == "none":
        return None, {}
    return kind, {"lr": float(getattr(args, "server_lr", 1.0)),
                  "momentum": float(getattr(args, "server_momentum", 0.9))}


def optimizer_from_args(args, n_params: int) -> Optional[ShardedOptimizer]:
    """A full-range optimizer for a server of ``n_params``, or None when
    ``--server-opt`` is off."""
    kind, kw = server_opt_from_args(args)
    if kind is None:
        return None
    return ShardedOptimizer(kind, 0, int(n_params), **kw)
