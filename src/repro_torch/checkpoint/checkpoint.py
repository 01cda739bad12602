"""Fault-tolerant checkpointing: atomic, async, keep-K, auto-resume.

The port of the reference's ``checkpoint/checkpoint.py``, in its on-disk
format, so a checkpoint written by either package restores into the
other's trees:

* ``step_{N:010d}/`` holds one ``.npy`` a leaf and ``manifest.json``
  (``{"step", "arrays": {key: {"file", "shape", "dtype"}}, "extra"}``).
  A leaf's key joins its path with ``/``: a dict key gives the key, a
  tuple or list the index, a NamedTuple field ``.`` and its name (the
  reference's ``jax.tree_util`` key strings: ``opt/.m/embed``,
  ``params/stack/0/mixer/w``); the file is the key with ``/`` as
  ``__``.  bf16 is stored as ``uint16`` under the manifest dtype
  ``"bfloat16"`` (bit views, no ``ml_dtypes``).
* **Atomic** — written into ``step_<N>.tmp/``, every file and the manifest
  flushed and fsync'd, then renamed; a stale ``.tmp`` is ignored and
  garbage-collected when a manager is created.
* **Async** — ``CheckpointManager.save(..., blocking=False)`` takes a host
  copy of every leaf synchronously, then writes it on a thread.  The copy
  is a real one also on the CPU, where ``.cpu()`` would return the tensor
  itself: the in-place AdamW step would otherwise rewrite a checkpoint
  still being written.
* **Keep-K + auto-resume** — checkpoints beyond ``keep`` are deleted after
  a successful write; ``restore_latest`` takes the newest directory that
  passes the integrity check (manifest readable, every array file there).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"

def _items(tree, prefix=()):
    """(path, leaf) pairs in the reference's order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, prefix + ("." + name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _flatten(tree) -> Dict[str, Any]:
    return dict(_items(tree))


def _to_numpy(t: torch.Tensor, copy: bool = False
              ) -> Tuple[np.ndarray, str]:
    """A host array of ``t`` (bf16 as its uint16 bits) and its manifest
    dtype; with ``copy``, one that shares no memory with ``t``."""
    t = t.detach()
    host = t.cpu()
    if copy and t.device.type == "cpu":
        host = host.clone()
    if t.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = host.numpy()
    return arr, str(arr.dtype)


def _unflatten_into(tree, flat: Dict[str, torch.Tensor], prefix=()):
    """``tree``'s structure with every leaf taken from ``flat`` by key,
    shape-checked, in the leaf's dtype and on its device."""
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten_into(v, flat, prefix + ("." + n,))
                            for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten_into(v, flat, prefix + (str(i),))
                          for i, v in enumerate(tree))
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing array {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(tree.shape):
        raise ValueError(f"shape mismatch for {key!r}: ckpt "
                         f"{tuple(arr.shape)} vs model {tuple(tree.shape)}")
    return arr.to(device=tree.device, dtype=tree.dtype)


def _host_copy(tree):
    """Every leaf as a host array that shares no memory with the leaf."""
    return {k: _to_numpy(v, copy=True) for k, v in _flatten(tree).items()}


def _write(directory: str, step: int, arrays: Dict[str, Tuple[np.ndarray,
                                                               str]],
           extra: Optional[Dict[str, Any]]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "arrays": {}, "extra": extra or {}}
    for key, (arr, dtype) in arrays.items():
        fname = key.replace("/", "__") + ".npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["arrays"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree, *,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic write; returns the final checkpoint path."""
    return _write(directory, step,
                  {k: _to_numpy(v) for k, v in _flatten(tree).items()},
                  extra)


def _valid(path: str) -> bool:
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.isfile(mpath):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        return all(os.path.isfile(os.path.join(path, meta["file"]))
                   for meta in manifest["arrays"].values())
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return False


def _steps(directory: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append((int(name[5:]), os.path.join(directory, name)))
            except ValueError:
                continue
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    for step, path in reversed(_steps(directory)):
        if _valid(path):
            return step
    return None


def load_checkpoint(directory: str, step: int, tree):
    """Load step N into the structure of ``tree`` (shape-checked; each leaf
    in the dtype and on the device of ``tree``'s).  Returns (the tree, the
    manifest's ``extra``)."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat = {}
    for key, meta in manifest["arrays"].items():
        arr = np.load(os.path.join(path, meta["file"]))
        if meta["dtype"] == "bfloat16":
            flat[key] = torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16)
        elif meta["dtype"] == str(arr.dtype):
            flat[key] = torch.from_numpy(arr)
        else:
            raise ValueError(f"{key!r}: dtype {meta['dtype']} stored as "
                             f"{arr.dtype} is not one the port reads")
    return _unflatten_into(tree, flat), manifest["extra"]


class CheckpointManager:
    """Async keep-K checkpointer with auto-resume."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        # GC stale tmp dirs from a previous crash
        for name in os.listdir(directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = [s for s in _steps(self.directory) if _valid(s[1])]
        for _, path in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(path, ignore_errors=True)

    def save(self, step: int, tree, *, extra: Optional[Dict] = None,
             blocking: bool = True):
        self.wait()                      # one outstanding write at a time
        # a host copy NOW: the next in-place step rewrites the tensors
        arrays = _host_copy(tree)

        def work():
            try:
                _write(self.directory, step, arrays, extra)
                self._gc()
            except BaseException as e:   # surfaced on next wait()/save()
                self._error = e

        if blocking:
            work()
            if self._error is not None:
                err, self._error = self._error, None
                raise err
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore_latest(self, tree) -> Optional[Tuple[int, Any, Dict]]:
        """(step, restored_tree, extra) from the newest valid ckpt, or None."""
        step = latest_step(self.directory)
        if step is None:
            return None
        restored, extra = load_checkpoint(self.directory, step, tree)
        return step, restored, extra
