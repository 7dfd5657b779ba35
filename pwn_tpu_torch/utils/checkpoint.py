"""Checkpoint / resume (counterpart of `pwn_tpu/utils/checkpoint.py`, which
is orbax: JAX), in the port's own format.

A checkpoint holds everything an exact resume needs: the parameters,
Adam's `mu`, `nu` and `count`, the step, the seed of the step noise
(`training/common.py::step_generator` draws from (seed, step), and the
KL warm-up reads the step), and the EMA parameters when they are tracked.
It is `<directory>/<step>/state.pt`: one `torch.save` of a flat dict of
CPU tensors and ints, keyed `params.<name>`, `opt.mu.<name>`,
`opt.nu.<name>`, `ema.<name>`, `step`, `seed`, `opt.count`, read back with
`torch.load(..., weights_only=True)`: no pickled objects.

Saves are atomic and asynchronous: `save` copies the state to the host at
once (the train step updates the parameters in place), then one
background thread writes it into a temporary sibling directory and
renames that to `<step>/` once the file is closed and synced, then prunes
to `max_to_keep`.  Only committed step directories count as steps, so a
crash mid-save leaves the previous step the latest.  A failed write
raises at the next `save`, `wait` or `close`.

A state sharded over the model axis (`parallel/tp.py`) is written whole:
every rank of its model group joins `gather_state`, and rank 0 saves what
it returns (`training/loop.py`), so the file is the same on every mesh and
resumes on any; the loop restores into the whole state and shards it
after.  A sharded state itself is refused here, in both directions.

`restore` copies into the template's own tensors in place: the model and
its TrainState share them, and `WaveNetStack`'s weight-layout cache keys
on each parameter's storage and version, which an in-place copy bumps.
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid
from typing import Dict, List, Optional, Tuple

import torch

from pwn_tpu_torch.training.common import TrainState

STATE_FILE = "state.pt"
_SCALARS = ("step", "seed", "opt.count")


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state's live tensors under their checkpoint keys."""
    if state.shard is not None:
        raise ValueError("a sharded state holds slices: checkpoint "
                         "parallel/tp.py::gather_state(state) instead")
    out = {f"params.{k}": p for k, p in state.params.items()}
    for name, mu, nu in zip(state.params, state.opt_state.mu,
                            state.opt_state.nu):
        out[f"opt.mu.{name}"] = mu
        out[f"opt.nu.{name}"] = nu
    if state.ema_params is not None:
        out.update({f"ema.{k}": e for k, e in state.ema_params.items()})
    return out


def snapshot(state: TrainState) -> Dict[str, object]:
    """The flat dict a checkpoint holds: host copies of every tensor, and
    the scalars."""
    flat: Dict[str, object] = {
        k: t.detach().to("cpu", copy=True)
        for k, t in state_tensors(state).items()}
    flat.update(step=int(state.step), seed=int(state.seed),
                **{"opt.count": int(state.opt_state.count)})
    return flat


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), STATE_FILE)

    def save(self, step: int, state: TrainState) -> None:
        """Snapshot `state` to the host now, write it in the background."""
        self.wait()
        flat = snapshot(state)
        self._thread = threading.Thread(target=self._write, args=(step, flat),
                                        name=f"ckpt-{step}", daemon=True)
        self._thread.start()

    def _write(self, step: int, flat: Dict[str, object]) -> None:
        try:
            tmp = os.path.join(self.directory,
                               f".tmp-{step}-{uuid.uuid4().hex}")
            os.makedirs(tmp)
            try:
                with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                    torch.save(flat, f)
                    f.flush()
                    os.fsync(f.fileno())
                final = os.path.join(self.directory, str(step))
                if os.path.isdir(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
            finally:
                if os.path.isdir(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        except Exception as e:  # raised to the caller by wait()
            self._error = e

    def all_steps(self) -> List[int]:
        """Committed checkpoint steps, ascending (the candidate ladder for
        distillability-aware teacher selection)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(self._path(int(n))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: TrainState,
                step: Optional[int] = None) -> Tuple[TrainState, int]:
        """Copy checkpoint `step` (default: the latest) into `template`'s
        tensors in place and set its step, seed and Adam count; the keys
        and shapes must match the template's exactly."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        targets = state_tensors(template)
        device = next(iter(template.params.values())).device
        flat = torch.load(self._path(step), weights_only=True,
                          map_location=device)
        want = set(targets) | set(_SCALARS)
        if set(flat) != want:
            raise ValueError(
                f"checkpoint {self._path(step)} does not fit the template: "
                f"missing {sorted(want - set(flat))[:5]}, unexpected "
                f"{sorted(set(flat) - want)[:5]}")
        for k, t in targets.items():
            if flat[k].shape != t.shape:
                raise ValueError(f"{k}: checkpoint shape "
                                 f"{tuple(flat[k].shape)}, template "
                                 f"{tuple(t.shape)}")
        with torch.no_grad():
            for k, t in targets.items():
                t.copy_(flat[k])
        template.step = flat["step"]
        template.seed = flat["seed"]
        template.opt_state.count = flat["opt.count"]
        return template, step

    def wait(self) -> None:
        """Join the pending write; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        self.wait()
