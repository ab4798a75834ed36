"""Checkpoint files (port of ``repro.checkpoint.ckpt``).

A tree (nested dicts, lists and tuples of numpy arrays or tensors,
``repro_torch.tree``) is written as one ``step_XXXXXXXX.npz`` plus a JSON
manifest beside it, in ``repro``'s layout: the npz holds each leaf under
its ``/``-joined path; the manifest holds ``step``, per-leaf ``dtype`` and
``spec`` (always null here) and, when given, ``meta``. Both packages read
each other's files.

What the sweep runner needs to trust a file from a run that may have been
killed mid-write:

* **provenance** — ``save_checkpoint(meta=...)`` stores a JSON dict in the
  manifest; :func:`load_manifest` reads it back;
* **integrity** — ``integrity=True`` stores a sha256 of each leaf's raw
  bytes (and its shape); ``restore_checkpoint(verify=True)`` recomputes
  them and raises :class:`CheckpointCorruptError` on a mismatch or an
  unreadable leaf;
* **atomic writes** — ``atomic=True`` writes both files under temporary
  names and renames them into place, manifest first and npz last, so an
  npz under its final name always has a complete manifest.

Placing leaves on a device mesh (``repro``'s ``specs`` and ``mesh``)
waits for the launch-tooling slice and raises ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.tree import tree_items

__all__ = ["save_checkpoint", "restore_checkpoint", "load_manifest",
           "CheckpointCorruptError"]

#: Torch dtypes numpy has no counterpart for; stored as float32, which
#: holds their values exactly, and restored to the dtype the manifest names.
_WIDENED = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class CheckpointCorruptError(Exception):
    """A checkpoint file failed an integrity check (truncated npz, content
    hash mismatch, missing manifest or leaf entry). Callers that can
    recompute the data catch it and recompute."""


def _no_mesh(specs, mesh) -> None:
    if specs is not None or mesh is not None:
        raise NotImplementedError(
            "repro_torch checkpoints do not place leaves on a device mesh "
            "yet (ROADMAP queue 1, item 9: launch tooling)")


def _leaf_array(leaf) -> tuple[np.ndarray, str]:
    """``(array to store, true dtype name)`` of one leaf."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if name in _WIDENED:
            return t.float().numpy(), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _content_hash(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order, the leaf order of
    ``repro``'s flattening."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def save_checkpoint(directory: str, step: int, tree, specs=None, *,
                    meta: dict | None = None, integrity: bool = False,
                    atomic: bool = False) -> str:
    """Write ``{directory}/step_{step:08d}.npz`` and its ``.json``
    manifest; returns the npz path. ``meta`` is stored verbatim (JSON);
    ``integrity=True`` adds each leaf's sha256 and shape; ``atomic=True``
    stages both files under temporary names and renames them into place,
    manifest first."""
    _no_mesh(specs, None)
    os.makedirs(directory, exist_ok=True)
    arrays, manifest = {}, {"step": step, "leaves": {}}
    if meta is not None:
        manifest["meta"] = meta
    for key, leaf in tree_items(_sorted(tree)):
        arr, dtype = _leaf_array(leaf)
        arrays[key] = arr
        entry = {"dtype": dtype, "spec": None}
        if integrity:
            entry["sha256"] = _content_hash(arr)
            entry["shape"] = list(arr.shape)
        manifest["leaves"][key] = entry
    base = os.path.join(directory, f"step_{step:08d}")
    if not atomic:
        np.savez(base + ".npz", **arrays)
        with open(base + ".json", "w") as f:
            json.dump(manifest, f, indent=1)
        return base + ".npz"
    tmp = f".tmp-{os.getpid()}"
    with open(base + ".npz" + tmp, "wb") as f:
        # through the handle: np.savez would append ".npz" to the name
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(base + ".json" + tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(base + ".json" + tmp, base + ".json")
    os.replace(base + ".npz" + tmp, base + ".npz")
    return base + ".npz"


def load_manifest(path: str) -> dict:
    """The manifest of a checkpoint's npz ``path`` (``step``, ``leaves``,
    and ``meta``, ``{}`` when none was stored). Raises
    :class:`CheckpointCorruptError` if it is missing or unreadable."""
    mpath = path.replace(".npz", ".json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint manifest {mpath}: {e}") from e
    manifest.setdefault("meta", {})
    return manifest


def _restored(arr: np.ndarray, dtype: str, like):
    """A stored array back in its true dtype: a tensor where ``like`` is a
    tensor (on its device) or numpy has no such dtype, else numpy."""
    if dtype in _WIDENED or torch.is_tensor(like):
        t = torch.from_numpy(np.array(arr))
        t = t.to(_WIDENED.get(dtype) or getattr(torch, dtype))
        return t.to(like.device) if torch.is_tensor(like) else t
    if str(arr.dtype) != dtype:
        arr = arr.astype(dtype)
    return arr


def _rebuild(like, leaves: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(
            _rebuild(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(like))
    return leaves[prefix]


def restore_checkpoint(path: str, like, mesh=None, *, verify: bool = False):
    """``(tree, step)``: the checkpoint at ``path`` in the structure of
    ``like``. ``verify=True`` recomputes each leaf's content hash against
    the manifest's ``sha256`` (where the file has one) and raises
    :class:`CheckpointCorruptError` on a mismatch or an unreadable leaf;
    a leaf missing from the npz raises ``KeyError``."""
    _no_mesh(None, mesh)
    manifest = load_manifest(path)
    try:
        data = np.load(path)
    except Exception as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint {path}: {e}") from e
    leaves = {}
    for key, leaf in tree_items(_sorted(like)):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        try:
            arr = data[key]
        except Exception as e:
            # a zip CRC failure or a truncated member: a torn write
            raise CheckpointCorruptError(
                f"corrupt checkpoint leaf {key!r} in {path}: {e}") from e
        entry = manifest["leaves"].get(key)
        if entry is None:
            raise CheckpointCorruptError(
                f"checkpoint manifest {path} has no entry for leaf {key!r}")
        if verify and entry.get("sha256") is not None:
            if _content_hash(arr) != entry["sha256"]:
                raise CheckpointCorruptError(
                    f"content hash mismatch for leaf {key!r} in {path} "
                    "(torn or corrupted write)")
        leaves[key] = _restored(arr, entry["dtype"], leaf)
    return _rebuild(like, leaves), manifest["step"]
