"""Atomic step checkpoints of a tree of tensors, written on the caller's
thread or on a worker (mirrors `repro.train.checkpoint`).

    ck = Checkpointer(directory, keep=3)
    ck.save(step, tree)                   # on disk when it returns
    ck.save(step, tree, blocking=False)   # copied to the host, then written
    ck.wait()                             #   by a worker until this returns
    tree, step = ck.restore(template)     # latest step (or step=...)

A tree is nested dicts, lists, tuples and NamedTuples (the optimizer's
`MomentState`) whose leaves are tensors or numpy arrays; None is no leaf.
Each leaf is stored under its logical key, the dict keys, sequence
indices and NamedTuple field names on its path joined by "/" (the
reference's `tree_flatten_with_path` keys), as one `.npy` file named by
the key with "/" as "__", beside a `manifest.json` of {"step", "leaves":
{key: {"file", "shape", "dtype"}}}: the reference's layout, so plain
nested dicts of fp32, int8, int32 and bool arrays that either package
saved restore in the other.  A leaf whose dtype numpy lacks (bfloat16)
raises at `save`.

Each save copies the leaves to the host on the caller's thread, then
writes them to a temporary directory, fsyncs every file and the
directory, and renames it into place, so a crash during a save leaves
the previous checkpoint whole.  Only the newest `keep` steps are kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

_MANIFEST = "manifest.json"
# torch dtypes with a numpy counterpart that np.save keeps
_NUMPY_DTYPES = frozenset({
    torch.float16, torch.float32, torch.float64, torch.int8, torch.int16,
    torch.int32, torch.int64, torch.uint8, torch.bool})


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    """{"/"-joined logical key: leaf} of a tree (None leaves dropped)."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(template, leaf, prefix: str = ""):
    """The template's tree with each leaf replaced by leaf(key, old)."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        return leaf(prefix, template)
    new = {k: _rebuild(v, leaf, f"{prefix}/{k}" if prefix else k)
           for k, v in kids}
    if isinstance(template, dict):
        return {k: new[str(k)] for k in template}
    if _is_namedtuple(template):
        return type(template)(**new)
    return type(template)(new[str(i)] for i in range(len(template)))


def _to_host(key: str, v) -> np.ndarray:
    """A host copy of one leaf that the train loop cannot change."""
    if isinstance(v, torch.Tensor):
        if v.dtype not in _NUMPY_DTYPES:
            raise TypeError(f"checkpoint leaf {key!r}: dtype {v.dtype} has "
                            f"no numpy counterpart")
        return v.detach().to("cpu", copy=True).numpy()
    return np.array(v, copy=True)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        """Until the pending save is on disk; raises its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Snapshot `tree` to the host, then write it as step `step`: here
        (blocking, the default) or on a worker thread, whose error the
        next `save` or `wait` raises.  The reference's default is the
        worker; here a blocking save raises a write error itself, which
        the streamed analysis relies on, and the train loop asks for the
        worker where the reference's saves are asynchronous."""
        self.wait()
        host = {k: _to_host(k, v) for k, v in _flatten(tree).items()}
        if blocking:
            self._write(step, host)
            return

        def work():
            try:
                self._write(step, host)
            except Exception as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _write(self, step: int, host: dict) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step}_{time.time_ns()}")
        os.makedirs(tmp)
        try:
            manifest = {}
            for k, v in host.items():
                fname = k.replace("/", "__") + ".npy"
                with open(os.path.join(tmp, fname), "wb") as f:
                    np.save(f, v)
                    f.flush()
                    os.fsync(f.fileno())
                manifest[k] = {"file": fname, "shape": list(v.shape),
                               "dtype": str(v.dtype)}
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump({"step": step, "leaves": manifest}, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
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

    def restore(self, template: Any, step: int | None = None):
        """(tree, step): the template's tree rebuilt from step `step` (the
        latest by default), each leaf a tensor on the device of the
        template's leaf (the CPU for a non-tensor leaf).  Raises
        FileNotFoundError when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)["leaves"]

        def leaf(key, old):
            arr = np.load(os.path.join(d, manifest[key]["file"]))
            device = old.device if isinstance(old, torch.Tensor) else "cpu"
            return torch.from_numpy(arr).to(device)

        return _rebuild(template, leaf), step
