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

**A sharded state** (:class:`ShardedCheckpointer`, the mesh modes of
``training/train_lm.py`` and the CNN's ``--mode fsdp``) keeps the same
layout and rules with one format for every mode: each step's file holds
**the mode's global tree**, gathered over the mesh (every rank takes part
in the gather, rank 0 writes): the full model's parameters by name, the
optimizer state with each per-parameter slot by the parameter's name, the
step, and the mode, the mesh shape and each leaf's global shape. A mode
describes where each of its rank's tensors comes from with a *layout*: one
``(name, local tensor, ops)`` per parameter, ``ops`` the steps from the
global leaf to the local one (``("split", axis, dim)``: this rank's chunk
of ``dim``; ``("rows", axis, dim)``: FSDP's storage, ``dim`` moved to the
front and chunked; ``("blocks", axis, per)``: a pipeline stage's blocks,
local block ``i`` being global block ``stage·per + i``). A restore reads the
file with ``mmap``, loads the parameters into the full model before the
mode's own shard function places it, then slices the optimizer state by
the layout, so the state lands directly in the mode's device layout. A
checkpoint of another mode, or of a model whose parameters differ, raises
``ValueError`` naming both sides; nothing is loaded in part. A restore into
another mesh shape of the same mode reshards.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
        if "mode" in payload:
            raise ValueError(f"checkpoint {path} holds a sharded run's state (--mode "
                             f"{payload['mode']}, mesh {payload['mesh']}); this run is "
                             "unsharded: restore it with that --mode")
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


# ------------------------------------------------------------ sharded states

#: one rank's view of a parameter: its global name, this rank's tensor (the
#: FSDP shard, or the module's own) and the ops from the global leaf to it
Layout = List[Tuple[str, torch.Tensor, Sequence[tuple]]]


def replicated_layout(state) -> Layout:
    """The layout of a state every rank holds whole (the sequence-parallel
    modes): no gather, rank 0's copy is the global tree."""
    return [(name, p, ()) for name, p in state.model.named_parameters()]


def gather_leaf(mesh, local: torch.Tensor, name: str, ops) -> Dict[str, torch.Tensor]:
    """The global leaves behind one rank's ``local`` tensor: ``{name:
    tensor}`` (several names for a pipeline stage's block). Collective: every
    rank of each op's axis calls it in the same order."""
    leaves = {name: local}
    for kind, axis, arg in reversed(list(ops)):
        n = mesh.axis_size(axis)
        out = {}
        for nm, x in leaves.items():
            pieces = list(mesh.all_gather(x.contiguous().reshape(-1), axis)
                          .view(n, -1).view(n, *x.shape))
            if kind == "split":
                out[nm] = torch.cat(pieces, arg)
            elif kind == "rows":
                out[nm] = torch.cat(pieces, 0).movedim(0, arg)
            elif kind == "blocks":
                head, i, rest = nm.split(".", 2)
                for r, piece in enumerate(pieces):
                    out[f"{head}.{r * arg + int(i)}.{rest}"] = piece
            else:
                raise ValueError(f"unknown layout op {kind!r}")
        leaves = out
    return {k: v.contiguous() for k, v in leaves.items()}


def slice_leaf(mesh, tree: Dict[str, torch.Tensor], name: str, ops) -> torch.Tensor:
    """This rank's piece of a global leaf of ``tree`` (the inverse of
    :func:`gather_leaf`)."""
    for kind, axis, arg in ops:
        if kind == "blocks":
            head, i, rest = name.split(".", 2)
            name = f"{head}.{mesh.axis_index(axis) * arg + int(i)}.{rest}"
    x = tree[name]
    for kind, axis, arg in ops:
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        if kind == "split":
            size = x.shape[arg] // n
            x = x.narrow(arg, i * size, size)
        elif kind == "rows":
            moved = x.movedim(arg, 0)
            rows = moved.shape[0] // n
            x = moved[i * rows:(i + 1) * rows]
    return x.contiguous()


def _opt_global(mesh, opt, layout: Layout) -> dict:
    slots = {}
    for slot, leaves in opt.slots.items():
        slots[slot] = {}
        for (name, _local, ops), leaf in zip(layout, leaves):
            slots[slot].update(gather_leaf(mesh, leaf, name, ops))
    return {"count": opt.count, "mini_step": opt.mini_step, "slots": slots,
            "inner": None if opt.inner is None else _opt_global(mesh, opt.inner, layout)}


def _opt_load(mesh, opt, tree: dict, layout: Layout) -> None:
    with torch.no_grad():
        opt.count.copy_(tree["count"])
        if opt.mini_step is not None:
            opt.mini_step.copy_(tree["mini_step"])
        if sorted(opt.slots) != sorted(tree["slots"]):
            raise ValueError(f"checkpoint's optimizer slots {sorted(tree['slots'])}, this "
                             f"run's {sorted(opt.slots)}")
        for slot, leaves in opt.slots.items():
            for (name, _local, ops), leaf in zip(layout, leaves):
                leaf.copy_(slice_leaf(mesh, tree["slots"][slot], name, ops))
        if opt.inner is not None:
            _opt_load(mesh, opt.inner, tree["inner"], layout)


class ShardedCheckpointer(Checkpointer):
    """Step-numbered checkpoints of a sharded ``--mode`` (see the module
    docstring): :class:`Checkpointer`'s layout, acceptance rule, retention
    and background write, one global tree a step.

    ``layout_fn(state) -> Layout`` describes this rank's tensors. Every
    rank calls :meth:`save` with the same steps (the gather is collective;
    a save's acceptance depends on the step and the steps saved, never on
    what another rank's writer has finished); rank 0 writes."""

    def __init__(self, directory: str, *, mode: str, mesh, layout_fn: Callable[[Any], Layout],
                 max_to_keep: int = 3, save_interval_steps: int = 1, background: bool = True):
        super().__init__(directory, max_to_keep=max_to_keep,
                         save_interval_steps=save_interval_steps, background=background)
        self.mode = str(mode)
        self.mesh = mesh
        self.layout_fn = layout_fn
        self._known = set(self.all_steps())
        #: the checkpoint :meth:`resume_full` loaded, for :meth:`restore_placed`
        self.restored: Optional[dict] = None

    def global_payload(self, step: int, state) -> dict:
        """The mode's global tree of ``state`` at ``step`` (collective)."""
        layout = self.layout_fn(state)
        params: Dict[str, torch.Tensor] = {}
        for name, local, ops in layout:
            params.update(gather_leaf(self.mesh, local.detach(), name, ops))
        return {"mode": self.mode, "mesh": dict(self.mesh.shape), "step": int(step),
                "shapes": {k: list(v.shape) for k, v in params.items()},
                "params": params, "opt_state": _opt_global(self.mesh, state.opt_state, layout)}

    def save(self, step: int, state, *, force: bool = False) -> bool:
        step = int(step)
        self.wait()
        if step in self._known or not (force or step % self.save_interval_steps == 0):
            return False
        self._known.add(step)
        payload = self.global_payload(step, state)
        if self.mesh.rank != 0:
            return True
        payload = _to_host(payload)
        if self.background:
            self._writer = threading.Thread(target=self._write_guarded, args=(step, payload),
                                            daemon=True)
            self._writer.start()
        else:
            self._write(step, payload)
        return True

    def load(self, step: Optional[int] = None) -> Optional[Tuple[dict, int]]:
        """``(payload, step)`` of the checkpoint at ``step`` (default: the
        latest), its tensors memory-mapped; ``None`` when there is none. A
        checkpoint of another mode raises ``ValueError``."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step), STATE_FILE)
        payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        mine = f"--mode {self.mode} (mesh {dict(self.mesh.shape)})"
        if "mode" not in payload:
            raise ValueError(f"checkpoint {path} holds an unsharded run's state; this run is "
                             f"{mine}")
        if payload["mode"] != self.mode:
            raise ValueError(f"checkpoint {path} is of --mode {payload['mode']} (mesh "
                             f"{payload['mesh']}); this run is {mine}")
        return payload, int(step)

    def restore_params(self, payload: dict, model) -> None:
        """Load the payload's parameters into the FULL ``model`` (before the
        mode's shard function places it). Their names and global shapes
        must be the model's, or ``ValueError`` names both."""
        want = {n: list(p.shape) for n, p in model.named_parameters()}
        have = {n: list(v) for n, v in payload["shapes"].items()}
        if want != have:
            missing = sorted(set(want) - set(have))[:4]
            extra = sorted(set(have) - set(want))[:4]
            differ = sorted(n for n in set(want) & set(have) if want[n] != have[n])[:4]
            raise ValueError(
                f"checkpoint of --mode {payload['mode']} (mesh {payload['mesh']}) holds "
                f"{len(have)} leaves, this run's model {len(want)}: missing {missing}, "
                f"extra {extra}, shapes differ {[(n, have[n], want[n]) for n in differ]}")
        # a model built on the meta device takes the checkpoint's tensors
        model.load_state_dict(payload["params"],
                              assign=any(p.is_meta for p in model.parameters()))

    def resume_full(self, state) -> int:
        """Restore the latest checkpoint's parameters into the full
        ``state.model`` (before the mode places it) and its step; the step
        restored, 0 when there is no checkpoint."""
        found = self.load()
        if found is None:
            return 0
        self.restore_params(found[0], state.model)
        self.restored, state.step = found
        return found[1]

    def restore_placed(self, state, payload: Optional[dict] = None) -> None:
        """After the mode placed the state: its optimizer state sliced by
        the layout, and the step (``payload`` by default the one
        :meth:`resume_full` loaded)."""
        payload = payload if payload is not None else self.restored
        _opt_load(self.mesh, state.opt_state, payload["opt_state"], self.layout_fn(state))
        state.step = int(payload["step"])
