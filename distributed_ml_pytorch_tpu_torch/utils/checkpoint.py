"""Checkpoint and resume of the single-process trainer (counterpart of the
JAX ``utils/checkpoint.py``; its orbax layout is not interchangeable with
this one).

- **Layout**: ``<dir>/<step>/state.pt``, one ``torch.save`` of the
  parameters, the optimizer state (its device counters included), the step
  and the dropout generator's state, written to ``state.pt.tmp`` and
  installed by ``os.replace``, so a reader never sees a torn file.
- **Acceptance** (orbax's rule): a save is accepted when ``force`` is set or
  ``step % save_interval_steps == 0``; saving a step that already exists is
  a no-op, so the trainer can offer every step and add a forced final save.
- **Retention**: the newest ``max_to_keep`` steps are kept.
- **Background writes**: the state is copied to the host on the caller's
  thread (the next step may then change the device tensors freely), and a
  writer thread serializes it; :meth:`Checkpointer.wait` joins it.
- **Exact mid-epoch resume**: the batch order is a pure function of
  ``(seed, epoch)`` (``data/cifar10.iterate_batches``), so the step alone
  fixes the batch to resume at (:func:`resume_position`).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import torch

STATE_FILE = "state.pt"


def _to_host(obj):
    """A copy of ``obj`` with every tensor on the host (detached)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_payload(state) -> dict:
    """What a checkpoint holds of a ``training.trainer.TrainState``."""
    gen = getattr(state, "generator", None)
    return {"step": int(state.step), "params": state.model.state_dict(),
            "opt_state": state.opt_state.state_dict(),
            "generator": None if gen is None else gen.get_state()}


def load_payload(state, payload: dict):
    """Copy a checkpoint's ``payload`` into ``state`` in place (parameters,
    optimizer tensors and generator keep their storage); returns ``state``."""
    state.model.load_state_dict(payload["params"])
    state.opt_state.load_state_dict(payload["opt_state"])
    gen = getattr(state, "generator", None)
    if gen is not None and payload["generator"] is not None:
        gen.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state


class Checkpointer:
    """Step-numbered checkpoints under ``directory`` (created if missing).

    ``max_to_keep``: the retention window; ``save_interval_steps``: offered
    saves at other steps are refused (unless forced); ``background``: write
    from a host copy on a thread (one write in flight at a time)."""

    def __init__(self, directory: str, *, max_to_keep: int = 3, save_interval_steps: int = 1,
                 background: bool = True):
        if int(save_interval_steps) < 1 or int(max_to_keep) < 1:
            raise ValueError("save_interval_steps and max_to_keep must be positive")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = int(save_interval_steps)
        self.background = bool(background)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        """Steps with a complete checkpoint, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Save ``state`` at ``step`` if the rule accepts it; True if it did."""
        step = int(step)
        self.wait()
        if step in self.all_steps() or not (force or step % self.save_interval_steps == 0):
            return False
        payload = _to_host(state_payload(state))
        if self.background:
            self._writer = threading.Thread(target=self._write_guarded, args=(step, payload),
                                            daemon=True)
            self._writer.start()
        else:
            self._write(step, payload)
        return True

    def _write_guarded(self, step: int, payload: dict) -> None:
        try:
            self._write(step, payload)
        except Exception as e:  # re-raised on the caller's thread by wait()
            self._error = e

    def _write(self, step: int, payload: dict) -> None:
        d = os.path.join(self.directory, str(step))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, STATE_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(d, STATE_FILE))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def restore(self, state, step: Optional[int] = None) -> Tuple[Any, int]:
        """Load the checkpoint at ``step`` (default: the latest) into
        ``state`` in place; returns ``(state, step)``. Raises
        ``FileNotFoundError`` when there is none."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        path = os.path.join(self.directory, str(step), STATE_FILE)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        return load_payload(state, payload), int(step)

    def wait(self) -> None:
        """Block until the write in flight has committed; re-raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def resume_position(step: int, steps_per_epoch: int) -> Tuple[int, int]:
    """Map a restored global step to ``(epoch, first_iter)``: ``step``
    batches are done, so training resumes at batch ``step % steps_per_epoch``
    of epoch ``step // steps_per_epoch``."""
    if steps_per_epoch <= 0:
        raise ValueError("steps_per_epoch must be positive")
    return step // steps_per_epoch, step % steps_per_epoch


def maybe_restore(ckpt: Optional[Checkpointer], state) -> Tuple[Any, int]:
    """Restore the latest checkpoint into ``state`` if one exists:
    ``(state, resume_step)``, ``resume_step = 0`` for a fresh run."""
    if ckpt is None or ckpt.latest_step() is None:
        return state, 0
    return ckpt.restore(state)
