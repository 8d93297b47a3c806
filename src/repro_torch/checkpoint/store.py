"""Sharded checkpointing with manifest integrity and auto-resume.

Layout per step:
  <dir>/step_<n>/
    manifest.json       # tree structure, shapes, dtypes, per-file sha256
    <leaf-path>.npy     # one file per tree leaf (gathered to host)

Saves run on a background thread (training continues), and ``latest_step``
skips manifests that fail integrity (a torn write from a crash mid-save is
detected, not resumed into) -- the restart path a real cluster needs.

The JAX package's format, file for file: leaf names join the path's dict
keys (sorted) and list indices with ``__``, a bf16 leaf is stored as its
bytes (``uint8`` of shape ``shape + (2,)``, logical dtype ``"bfloat16"``),
so a step written by either package restores in the other bit for bit.
Leaves are tensors (or NumPy arrays); ``restore`` returns tensors placed
like the leaves of ``tree_like`` and reads bf16 through
``torch.from_numpy(...).view(torch.bfloat16)``.

On a device mesh a leaf may be a DTensor: ``save`` gathers each one whole
(a collective, so every rank calls it) and rank 0 writes the step.
``restore(shardings=)`` places each leaf by its ``NamedSharding``, every
rank taking its own shard of the stored array -- how a re-planned mesh
reloads a checkpoint written under another topology.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.models.common import tree_leaves_with_path

__all__ = ["save", "save_async", "restore", "latest_step", "Checkpointer"]


def _leaf_paths(tree: Any):
    for path, leaf in tree_leaves_with_path(tree):
        name = "/".join(str(p) for p in path)
        yield name.replace("/", "__"), leaf


def _sha(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf on the host as (what ``np.save`` writes, its logical dtype):
    bf16 as its little-endian bytes, one trailing axis of 2."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        raw = t.reshape(-1).view(torch.uint8).reshape(tuple(t.shape) + (2,))
        return raw.numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    if str(arr.dtype) == logical:
        return torch.from_numpy(arr)
    if logical != "bfloat16" or arr.dtype != np.uint8 \
            or arr.shape[-1:] != (2,):
        raise ValueError(f"stored {arr.dtype}{list(arr.shape)} is not a "
                         f"{logical} leaf")
    return torch.from_numpy(arr).view(torch.bfloat16)[..., 0]


def _gather(tree: Any) -> tuple:
    """(the tree with each DTensor leaf gathered whole, the device mesh of
    the first one or ``None``)."""
    from torch.distributed.tensor import DTensor

    meshes = []

    def whole(x):
        if isinstance(x, DTensor):
            meshes.append(x.device_mesh)
            return x.full_tensor()
        return x

    tree = _map(whole, tree)
    return tree, (meshes[0] if meshes else None)


def _writer(mesh) -> bool:
    """The rank that writes a gathered tree: the mesh's first."""
    return mesh is None or not any(mesh.get_coordinate())


def save(tree: Any, directory: str | Path, step: int) -> Path:
    d = Path(directory) / f"step_{step:08d}"
    tree, mesh = _gather(tree)
    if mesh is None:
        return _write(tree, d, step)
    import torch.distributed as dist
    if _writer(mesh):
        _write(tree, d, step)
    for i in range(mesh.ndim):      # every rank of the mesh waits for it
        dist.barrier(group=mesh.get_group(i))
    return d


def _write(tree: Any, d: Path, step: int) -> Path:
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in _leaf_paths(tree):
        arr, logical = _to_numpy(leaf)
        f = tmp / f"{name}.npy"
        np.save(f, arr)
        manifest["leaves"][name] = {
            "shape": list(arr.shape), "dtype": logical,
            "sha256": _sha(f),
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)  # atomic-ish publish
    return d


def _host_copy(x):
    """A snapshot the caller cannot change: training writes its state in
    place, so a CPU tensor is copied too."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


def save_async(tree: Any, directory: str | Path, step: int) -> threading.Thread:
    tree, mesh = _gather(tree)
    host_tree = _map(_host_copy, tree)
    target = save if _writer(mesh) else (lambda *a: None)
    t = threading.Thread(target=target, args=(host_tree, directory, step),
                         daemon=True)
    t.start()
    return t


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def verify(d: Path) -> bool:
    mf = d / "manifest.json"
    if not mf.exists():
        return False
    try:
        manifest = json.loads(mf.read_text())
        for name, info in manifest["leaves"].items():
            f = d / f"{name}.npy"
            if not f.exists() or _sha(f) != info["sha256"]:
                return False
        return True
    except (OSError, ValueError, KeyError, TypeError):
        return False


def latest_step(directory: str | Path) -> int | None:
    root = Path(directory)
    if not root.exists():
        return None
    steps = sorted((int(p.name.split("_")[1]) for p in root.glob("step_*")
                    if p.is_dir() and p.name.split("_")[1].isdigit()),
                   reverse=True)
    for s in steps:
        if verify(root / f"step_{s:08d}"):
            return s
    return None


def restore(tree_like: Any, directory: str | Path, step: int,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``tree_like`` (shapes validated).

    Each leaf comes back as a tensor in its stored dtype, on the device of
    the matching ``tree_like`` leaf when that is a tensor (else on the
    CPU).  ``shardings``: optional matching tree of ``NamedSharding``
    (``parallel/sharding.py``) -- each leaf with one becomes a DTensor on
    its mesh's device, every rank keeping its own shard of the stored
    array, which is how a *re-planned* (elastic) mesh reloads a checkpoint
    written under a different topology.
    """
    from torch.distributed.tensor import distribute_tensor

    d = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_sh = (dict(tree_leaves_with_path(shardings))
               if shardings is not None else {})
    pairs = []
    for path, leaf in tree_leaves_with_path(tree_like):
        name = "/".join(str(p) for p in path).replace("/", "__")
        arr = np.load(d / f"{name}.npy")
        out = _from_numpy(arr, manifest["leaves"][name]["dtype"])
        want = tuple(getattr(leaf, "shape", out.shape))
        if tuple(out.shape) != want:
            raise ValueError(f"{name}: checkpoint {tuple(out.shape)} != "
                             f"model {want}")
        sh = flat_sh.get(path)
        if sh is not None:
            out = distribute_tensor(out.to(sh.mesh.device),
                                    sh.mesh.device_mesh, sh.placements,
                                    src_data_rank=None)
        elif isinstance(leaf, torch.Tensor):
            out = out.to(leaf.device)
        pairs.append((path, out))
    return _unflatten_like(tree_like, iter(pairs))


def _unflatten_like(like, pairs):
    """``like``'s structure with its leaves replaced, in leaf order."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten_like(like[k], pairs) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, pairs) for v in like)
    return next(pairs)[1]


class Checkpointer:
    """Every-N-steps async checkpointing with bounded retention."""

    def __init__(self, directory: str | Path, every: int = 100, keep: int = 3):
        self.dir = Path(directory)
        self.every = every
        self.keep = keep
        self._thread: threading.Thread | None = None

    def maybe_save(self, tree: Any, step: int):
        if step % self.every:
            return
        if self._thread is not None:
            self._thread.join()  # one in flight at a time
        self._thread = save_async(tree, self.dir, step)
        self._gc()

    def _gc(self):
        steps = sorted((int(p.name.split("_")[1])
                        for p in self.dir.glob("step_*")
                        if p.name.split("_")[1].isdigit()), reverse=True)
        for s in steps[self.keep:]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def finalize(self):
        if self._thread is not None:
            self._thread.join()
