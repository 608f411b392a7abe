"""Checkpointing with a manifest, atomic commit and async save.

Port of ``repro/checkpoint/sharded.py``.  The layout and the manifest are
the reference's, so either package restores the other's checkpoints::

    ckpt_dir/
      step_000100/
        manifest.json        # leaf keys, shapes, dtypes, files
        leaf_00000.npy       # one file per leaf (np.save; bf16 as u16)
        ...
        COMMIT               # written last: crash-safe commit marker

* **Atomic commit**: a checkpoint without ``COMMIT`` is ignored by
  ``latest_step``; the step is written into a ``.tmp`` directory that is
  renamed into place once committed.
* **Leaves**: torch tensors (on any device), numpy arrays and Python
  scalars, in trees of dicts, lists and tuples.  A leaf's key is the
  reference's ``jax.tree_util.keystr`` of its path (``"['state.x']"``,
  ``"['a'][0]"``), dict keys in sorted order as JAX flattens them.  Every
  leaf is saved as a full host array; ``restore_checkpoint(...,
  device=)`` places the restored leaves on a torch device.
* **bfloat16**, which numpy lacks, is stored as its uint16 bit pattern
  with the true dtype in the manifest, and restored as a torch tensor.
* **Async save**: :class:`CheckpointManager` copies to the host, then
  writes on a background thread, with at most one write outstanding.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.device import DeviceLike

_BF16 = "bfloat16"


# ---- trees of dicts / lists / tuples ---------------------------------------

def _is_node(x) -> bool:
    return isinstance(x, dict) or type(x) in (list, tuple)


def _leaf_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{keystr: leaf}`` in JAX's flattening order: dict keys sorted,
    sequence items by index, ``None`` an empty subtree."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_leaf_paths(tree[k], f"{prefix}[{k!r}]"))
    elif type(tree) in (list, tuple):
        for i, v in enumerate(tree):
            out.update(_leaf_paths(v, f"{prefix}[{i}]"))
    elif tree is not None:
        out[prefix] = tree
    return out


def _tree_map(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(keystr, leaf)``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_tree_map(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


# ---- leaves ----------------------------------------------------------------

def _dtype_name(x) -> str:
    """The manifest's dtype: numpy's name, also for a torch tensor."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(x.dtype) if hasattr(x, "dtype") else str(np.asarray(x).dtype)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(x)


def _from_numpy(x: np.ndarray, dtype: str):
    if dtype == _BF16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return x


def _storage_dtype(path: str, name: str) -> np.dtype:
    if name == _BF16:
        return np.dtype(np.uint16)
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"manifest leaf {path!r}: dtype {name!r} has no "
                         f"numpy or torch counterpart") from None


def _host_copy(_path: str, x):
    """What an async save keeps of a leaf: a host copy of a tensor (its
    dtype kept), anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


# ---- save / restore --------------------------------------------------------

def save_checkpoint(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Synchronous save with atomic commit.

    Manifest format (``manifest.json``), the reference's::

        {"step": <int>,
         "leaves": {"<keystr>": {"file":  "leaf_00000.npy",
                                 "shape": [..],
                                 "dtype": "float32" | "bfloat16" | ...}}}

    Leaves are written one ``.npy`` per entry in sorted-key order.
    ``COMMIT`` is written last inside a ``.tmp`` directory that is
    atomically renamed into place — readers trust only directories
    containing COMMIT."""
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = _leaf_paths(tree)
    manifest = {"step": step, "leaves": {}}
    for i, (path, leaf) in enumerate(sorted(leaves.items())):
        arr = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][path] = {"file": fname,
                                    "shape": list(arr.shape),
                                    "dtype": _dtype_name(leaf)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    _write_commit(tmp)
    _publish(tmp, out)
    _gc(ckpt_dir, keep)
    return out


def _write_commit(tmp: str) -> None:
    """Write the COMMIT marker into a fully-written ``.tmp`` step
    directory.  A separate function so crash-injection tests can kill
    exactly here: leaves + manifest on disk, marker absent — the
    directory must stay invisible to :func:`latest_step`."""
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write(str(time.time()))


def _publish(tmp: str, out: str) -> None:
    """Atomically publish a committed ``.tmp`` step directory under its
    final name.  A separate function so crash-injection tests can kill
    exactly here: the commit marker exists but only inside ``.tmp``,
    which readers ignore — the previous published step stays intact."""
    if os.path.exists(out):
        shutil.rmtree(out)
    os.replace(tmp, out)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def manifest_target(ckpt_dir: str, step: int) -> Dict[str, np.ndarray]:
    """Rebuild a zeros ``{name: array}`` dict from a saved checkpoint's
    manifest, for checkpoints of flat dicts (the serving layer's job
    checkpoints): a restarted process has no in-memory tree to validate
    against, and every leaf key of a flat dict is ``['name']``."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, np.ndarray] = {}
    for path, meta in manifest["leaves"].items():
        if not (path.startswith("['") and path.endswith("']")) \
                or "']['" in path:
            raise ValueError(
                f"manifest leaf {path!r} is not a flat dict key; "
                f"manifest_target only supports flat {{name: array}} trees")
        out[path[2:-2]] = np.zeros(tuple(meta["shape"]),
                                   _storage_dtype(path, meta["dtype"]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Highest committed step, or None (uncommitted dirs are ignored)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "COMMIT")):
            best = max(best or -1, int(d.split("_")[1]))
    return best


def restore_checkpoint(ckpt_dir: str, step: int, target_tree,
                       device: DeviceLike = None):
    """Restore into the structure of ``target_tree`` (shapes validated).

    Every manifest leaf must exist in ``target_tree`` and vice versa, and
    each leaf file's shape is validated against both the manifest and the
    target; mismatches raise, so a checkpoint is never partially or
    silently restored.  Leaves come back as numpy arrays (bfloat16 ones as
    CPU torch tensors), or, with ``device``, as torch tensors there."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _leaf_paths(target_tree)
    out = {}
    for path, meta in manifest["leaves"].items():
        if path not in leaves:
            raise KeyError(f"checkpoint leaf {path} missing from target")
        _storage_dtype(path, meta["dtype"])
        arr = _from_numpy(np.load(os.path.join(src, meta["file"])),
                          meta["dtype"])
        expect = tuple(meta["shape"])
        if tuple(arr.shape) != expect:
            raise ValueError(f"{path}: shape {tuple(arr.shape)} != {expect}")
        if hasattr(leaves[path], "shape") and \
                tuple(leaves[path].shape) != expect:
            raise ValueError(f"{path}: checkpoint shape {expect} != target "
                             f"{tuple(leaves[path].shape)}")
        if device is not None:
            arr = torch.as_tensor(arr).to(device)
        out[path] = arr
    missing = set(leaves) - set(manifest["leaves"])
    if missing:
        raise KeyError(f"target leaves missing from checkpoint: {missing}")
    return _tree_map(lambda path, _leaf: out[path], target_tree)


class CheckpointManager:
    """Async double-buffered checkpointing.

    ``save(step, tree)`` copies to the host (blocking only on the
    device-to-host copy), then writes on a background thread; a new save
    joins the previous thread first (at most one outstanding write)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None

    def save(self, step: int, tree, blocking: bool = False):
        host_tree = _tree_map(_host_copy, tree)
        self.wait()

        def _write():
            save_checkpoint(self.ckpt_dir, step, host_tree, keep=self.keep)
            self.last_saved = step

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, target_tree, device: DeviceLike = None):
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.ckpt_dir, step, target_tree,
                                        device=device)
