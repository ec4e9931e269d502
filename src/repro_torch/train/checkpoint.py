"""Atomic step checkpoints of a flat dict of tensors (the part of
`repro.train.checkpoint` that the streamed k-mer analysis needs).

    ck = Checkpointer(directory, keep=2)
    ck.save(step, {"bits": t, ...})    # on disk when it returns
    state, step = ck.restore(template)  # latest step, template's devices

Each save copies the tensors to the host, writes them to a temporary
directory, fsyncs the file and the directory, and renames the directory
into place, so a crash during a save leaves the previous checkpoint
whole.  Only the newest `keep` steps are kept.
"""
from __future__ import annotations

import os
import shutil
import time

import torch

_STATE = "state.pt"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 2):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, state: dict) -> None:
        """Write `state` (name -> tensor) as step `step`."""
        host = {k: torch.as_tensor(v).detach().to("cpu", copy=True)
                for k, v in state.items()}
        tmp = os.path.join(self.dir, f".tmp_step_{step}_{time.time_ns()}")
        os.makedirs(tmp)
        path = os.path.join(tmp, _STATE)
        with open(path, "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        _fsync_dir(self.dir)
        self._gc()

    def _gc(self) -> None:
        for s in self.list_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def list_steps(self) -> list:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def latest_step(self):
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template: dict):
        """(state, step): the tensors of the latest step, each on the
        device of the template's tensor of that name.  Raises
        FileNotFoundError when there is no checkpoint."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}", _STATE)
        saved = torch.load(path, map_location="cpu", weights_only=True)
        state = {k: saved[k].to(torch.as_tensor(v).device)
                 for k, v in template.items()}
        return state, step
