"""Checkpointing (the JAX package's ``checkpoint/checkpoint.py``), in the
reference's on-disk format, so a checkpoint written by either package
restores in the other.

* **atomic**: a checkpoint directory is staged as ``step_N.tmp`` and
  ``os.rename``d into place -- a crash mid-write can never produce a
  half-readable "latest" checkpoint;
* **the reference's files**: ``step_{N:08d}/leaf_{i:05d}.npy`` plus a
  ``manifest.json`` with ``step``, ``n_leaves``, ``treedef``, ``extra``,
  ``dtypes`` and ``shapes``. A train state (a dict whose ``"params"`` is a
  :class:`~repro_torch.models.model.Model`) is written leaf for leaf as the
  reference's train-state tree, each per-layer tensor as its row of the
  reference's stacked leaf (:func:`repro_torch.models.convert
  .train_state_leaves`); any other tree of dicts, lists and tuples is
  flattened as ``jax.tree_util`` flattens it (dict keys sorted). The
  ``treedef`` entry lists the leaves' paths; restoring reads only
  ``n_leaves`` and the leaves, as the reference does;
* **bf16 as raw bits**: a bf16 leaf is written as its 16-bit patterns
  under the same ``<V2`` header the reference's ``np.save`` of an
  ``ml_dtypes`` array writes, and restored by reinterpreting those bits as
  ``torch.bfloat16`` from the manifest's ``dtypes`` entry. (The
  reference's own restore hands such a leaf back as a ``|V2`` array that
  JAX cannot place on a device, so it cannot resume a bf16 run; the port
  can.) No ``ml_dtypes`` is needed;
* **async**: :class:`AsyncCheckpointer` snapshots to host memory
  synchronously and does the disk I/O on a background thread;
* **self-pruning**: keeps the last ``keep`` checkpoints;
* **mesh-agnostic**: a DTensor leaf is written as its full logical value
  (``full_tensor()``, a collective every rank joins; rank 0 alone writes
  the files, and waiting for a save ends in a barrier), and restored by
  every rank reading the full leaf and keeping the shards of the target's
  own placements, so a state saved on one mesh shape restores onto
  another. The bytes on disk do not depend on the mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.convert import train_state_leaves, tree_leaves

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "AsyncCheckpointer",
]

_MANIFEST = "manifest.json"
_BF16_DESCR = "<V2"  # what np.save writes for an ml_dtypes bfloat16 array


class _HostLeaf(NamedTuple):
    """One leaf on the host: ``array`` holds its values (a bf16 leaf's as
    uint16 bit patterns) and ``dtype`` names its dtype as the manifest
    does."""

    array: np.ndarray
    dtype: str


def _is_train_state(tree: Any) -> bool:
    return isinstance(tree, dict) and isinstance(tree.get("params"), nn.Module)


def _flatten(tree: Any) -> List[Tuple[Tuple, List[Any], bool]]:
    """``(path, values, stacked)`` per leaf, in the reference's order."""
    if _is_train_state(tree):
        return train_state_leaves(tree)
    return [(path, [leaf], False) for path, leaf in tree_leaves(tree)]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(values: List[Any], stacked: bool) -> _HostLeaf:
    """A leaf's host snapshot. Tensors are copied from their device into
    a buffer allocated once per leaf (the rows of a stacked leaf straight
    into their slots); the copy from a CUDA tensor into pageable memory
    returns after the device has written it."""
    first = values[0]
    if not isinstance(first, torch.Tensor):  # a numpy array or scalar
        arr = np.array(first)
        return _HostLeaf(arr, str(arr.dtype))
    if isinstance(first, DTensor):  # the full logical value (a collective)
        values = [t.full_tensor() for t in values]
        first = values[0]
    dtype = _dtype_name(first)
    bits = torch.int16 if first.dtype == torch.bfloat16 else first.dtype
    shape = ((len(values),) if stacked else ()) + tuple(first.shape)
    buf = torch.empty(shape, dtype=bits)
    with torch.no_grad():
        if stacked:
            for r, t in enumerate(values):
                buf[r].copy_(t.detach().view(bits))
        else:
            buf.copy_(first.detach().view(bits))
    arr = buf.numpy()
    return _HostLeaf(arr.view(np.uint16) if dtype == "bfloat16" else arr, dtype)


def _write_leaf(path: str, leaf: _HostLeaf) -> None:
    if leaf.dtype != "bfloat16":
        np.save(path, leaf.array)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": leaf.array.shape}
        )
        np.ascontiguousarray(leaf.array).tofile(f)


def _save_host(directory: str, step: int, leaves: List[Tuple[Tuple, _HostLeaf]],
               extra: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for i, (_, leaf) in enumerate(leaves):
        _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": "leaf paths: " + ", ".join("/".join(map(str, p)) for p, _ in leaves),
        "extra": extra or {},
        "dtypes": [leaf.dtype for _, leaf in leaves],
        "shapes": [list(leaf.array.shape) for _, leaf in leaves],
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _snapshot(tree: Any) -> List[Tuple[Tuple, _HostLeaf]]:
    return [(path, _to_host(values, stacked)) for path, values, stacked in _flatten(tree)]


def _distributed(tree: Any) -> bool:
    return any(isinstance(v, DTensor) for _, values, _ in _flatten(tree) for v in values[:1])


def _writer() -> bool:
    """Whether this process writes checkpoint files: rank 0, or a process
    without a process group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory: str, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
    """Write atomically; returns the final path. A tree of DTensors is
    snapshotted by every rank, written by rank 0, and every rank returns
    after the files are in place."""
    host = _snapshot(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    if _writer():
        final = _save_host(directory, step, host, extra)
    if _distributed(tree):
        import torch.distributed as dist

        dist.barrier()
    return final


def _steps(directory: str) -> List[int]:
    return sorted(
        int(name.split("_")[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and not name.endswith(".tmp")
    )


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(
    directory: str,
    target: Any,
    step: Optional[int] = None,
    device=None,
) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``target``. Returns (tree, step,
    extra).

    A train state is restored in place: every tensor it holds receives
    its leaf (or its row of a stacked leaf) on the device it lies on, and
    the same state is returned -- no second copy of the state is
    allocated on the device. Any other tree comes back as a new tree of
    the same structure whose leaves are tensors on ``device`` (the host
    when None, as the reference's ``shardings=None`` gives host arrays).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = _flatten(target)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target has {len(leaves)}"
        )
    dtypes = manifest.get("dtypes") or [None] * len(leaves)
    loaded = [_load_leaf(os.path.join(path, f"leaf_{i:05d}.npy"), dtypes[i])
              for i in range(len(leaves))]
    extra = manifest.get("extra", {})
    if _is_train_state(target):
        with torch.no_grad():
            for (where, values, stacked), value in zip(leaves, loaded):
                rows = list(value) if stacked else [value]
                if len(rows) != len(values) or any(t.shape != r.shape for t, r in zip(values, rows)):
                    raise ValueError(f"{'/'.join(map(str, where))}: checkpoint leaf of shape "
                                     f"{tuple(value.shape)} does not fit the target")
                for t, r in zip(values, rows):
                    if isinstance(t, DTensor):  # keep this rank's shards
                        r = distribute_tensor(r.to(t.device), t.device_mesh, t.placements,
                                              src_data_rank=None)
                        t.to_local().copy_(r.to_local())
                    else:
                        t.copy_(r)
        return target, step, extra
    if device is not None:
        loaded = [t.to(device) for t in loaded]
    return _unflatten(target, iter(loaded)), step, extra


def _unflatten(tree: Any, leaves):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _prune(directory: str, keep: int) -> None:
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write-to-disk on a worker thread.

    :meth:`save` returns once every leaf has been copied off the device
    into host memory, so the train step may then update the state in
    place; the files are written, and old checkpoints pruned, while the
    next steps run. One write is in flight at a time. ``saves`` records
    each save: its step, bytes, the seconds the caller waited for the
    snapshot (``snapshot_s``) and, once written, the worker's seconds
    (``write_s``).
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.saves: List[Dict[str, float]] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False

    def wait(self) -> None:
        """Wait for the write in flight; after a DTensor save every rank
        waits until rank 0's files are in place."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist

            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()  # one in-flight write at a time
        t0 = time.perf_counter()
        host = _snapshot(tree)  # device -> host, complete on return
        self._barrier = _distributed(tree)
        if not _writer():
            return
        record = {"step": step, "bytes": sum(leaf.array.nbytes for _, leaf in host),
                  "snapshot_s": time.perf_counter() - t0}
        self.saves.append(record)

        def work():
            try:
                t1 = time.perf_counter()
                _save_host(self.directory, step, host, extra)
                record["write_s"] = time.perf_counter() - t1
                _prune(self.directory, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
