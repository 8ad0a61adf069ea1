"""Atomic, versioned checkpoints of tensor trees (counterpart of
``repro.checkpoint.checkpointer``), in the reference's on-disk format.

Layout (one directory per step)::

    <root>/step_00000010.tmp-<nonce>/   # written first
        manifest.json                    # leaf paths, shapes, dtypes, metadata
        arr_00000.p0.npy ...             # one file per leaf
    <root>/step_00000010/                # atomic rename on completion

* **atomicity**: readers never see a partial checkpoint (tmp dir + rename);
* **versioning**: ``latest_step`` scans completed directories only, and
  ``keep`` bounds how many stay;
* **async save**: every leaf is copied to fresh host memory on the
  caller's thread (a CPU tensor too: the optimizer updates its leaves in
  place, and the next step must not reach a checkpoint still being
  written), the file writes run on a background thread; ``wait()`` joins
  it and raises what it raised;
* **the reference's format**: leaves in the reference's order (dict keys
  sorted, NamedTuple fields in order), paths spelled as
  ``jax.tree_util.keystr`` spells them, dtypes by numpy's names, and bf16
  (and fp8) stored as a bit-identical unsigned-integer view with the
  logical dtype in the manifest. A checkpoint of a dict tree written by
  either package restores in the other; that is how weights carry across.

Sharded trees: ``save`` gathers each DTensor leaf whole
(``full_tensor()``, a collective, so every rank of the mesh calls it) and
rank 0 alone writes; every leaf is stored whole (``p0``), so the format
stays the reference's, with no layout in it. ``restore`` places each leaf
on the device of the ``like`` leaf it replaces, or, given ``placements``
(a tree of :class:`~repro_torch.distributed.sharding.Layout` shaped like
``like``, the reference's ``shardings``), on the mesh and in the layout
the new run chose: a checkpoint saved at one world size restores at
another.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.training.tree import flatten_with_paths, leaves, unflatten

#: Dtypes numpy's .npy cannot hold: stored as a bit-identical integer view.
_EXOTIC_DTYPES = {
    "bfloat16": (np.uint16, torch.int16),
    "float8_e4m3fn": (np.uint8, torch.uint8),
    "float8_e5m2": (np.uint8, torch.uint8),
}


def _to_host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array to store, logical dtype name), in memory of
    its own: later in-place updates of ``leaf`` do not reach it."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if name in _EXOTIC_DTYPES:
            np_view, torch_view = _EXOTIC_DTYPES[name]
            return t.view(torch_view).numpy().view(np_view), name
        return t.numpy(), name
    arr = np.array(leaf)
    name = str(arr.dtype)
    if name in _EXOTIC_DTYPES:  # an ml_dtypes array
        return arr.view(_EXOTIC_DTYPES[name][0]), name
    return arr, name


def _from_host(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _EXOTIC_DTYPES:
        torch_view = _EXOTIC_DTYPES[name][1]
        signed = np.int16 if torch_view is torch.int16 else np.uint8
        return torch.from_numpy(arr.view(signed).copy()).view(getattr(torch, name))
    return torch.from_numpy(np.array(arr))


def _treedef_repr(tree: Any) -> str:
    """The tree's structure, written as the reference's ``PyTreeDef`` repr
    writes it (informational: restore reads the structure from ``like``)."""
    def rep(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {rep(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            inner = ", ".join(rep(getattr(node, f)) for f in node._fields)
            return f"CustomNode(namedtuple[{type(node).__name__}], [{inner}])"
        if isinstance(node, (tuple, list)):
            inner = ", ".join(rep(x) for x in node)
            return f"({inner})" if isinstance(node, tuple) else f"[{inner}]"
        return "None" if node is None else "*"

    return f"PyTreeDef({rep(tree)})"


class Checkpointer:
    def __init__(self, root: str, *, keep: int = 3, async_save: bool = False) -> None:
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> str:
        """Save a tree at ``step``. Returns the final directory path. With
        DTensor leaves every rank calls it; rank 0 writes."""
        self.wait()
        host = [(*_to_host(leaf), path) for path, leaf in flatten_with_paths(tree)]
        final = self._step_dir(step)
        if dist.is_initialized() and dist.get_rank() != 0:
            return final
        manifest = {
            "step": step,
            "time": time.time(),
            "process_index": 0,
            "process_count": 1,
            "metadata": metadata or {},
            "leaves": [
                {
                    "index": i,
                    "path": path,
                    "shape": list(arr.shape),
                    "dtype": name,
                    "file": f"arr_{i:05d}.p0.npy",
                }
                for i, (arr, name, path) in enumerate(host)
            ],
            "treedef": _treedef_repr(tree),
        }

        def write() -> None:
            tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
            try:
                os.makedirs(tmp, exist_ok=True)
                for i, (arr, _, _) in enumerate(host):
                    np.save(os.path.join(tmp, f"arr_{i:05d}.p0.npy"), arr)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f, indent=1)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:  # surfaced at the next wait()
                self._error = e
                raise

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return final

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    # -- restore ---------------------------------------------------------------
    def restore(self, like: Any, *, step: Optional[int] = None,
                placements: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` → (tree, metadata). Each
        leaf is a tensor of the stored dtype, on the device of the ``like``
        leaf it replaces (the CPU where that leaf is not a tensor), or with
        ``placements`` a DTensor in the :class:`Layout` at its position."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like_leaves = leaves(like)
        if len(like_leaves) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, expected {len(like_leaves)}"
            )
        where = [None] * len(like_leaves) if placements is None else leaves(placements)
        if len(where) != len(like_leaves):
            raise ValueError(f"{len(where)} placements for {len(like_leaves)} leaves")
        out = []
        for entry, ref, layout in zip(manifest["leaves"], like_leaves, where):
            t = _from_host(np.load(os.path.join(d, entry["file"])), entry["dtype"])
            if layout is not None:
                out.append(layout.place(t.to(layout.mesh.device_type)))
            else:
                out.append(t.to(ref.device) if isinstance(ref, torch.Tensor) else t)
        return unflatten(like, out), manifest["metadata"]

    # -- bookkeeping -----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def completed_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and ".tmp" not in name:
                if os.path.exists(os.path.join(self.root, name, "manifest.json")):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.completed_steps()
        return steps[-1] if steps else None

    def _gc(self) -> None:
        steps = self.completed_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
