"""Atomic, async checkpointing in the reference's on-disk format (port of
``repro.checkpoint.ckpt``), and crash-safe JSON writes.

Layout:  <dir>/step_<N>/
           manifest.json      step, and per leaf: path, file, shape, dtype,
                              CRC32 of its bytes
           leaf_NNNNN.npy     one file per leaf

Leaves carry the reference's paths: dict keys joined by "/", sorted, with
every list of the port's trees (``blocks``, an encoder's ``blocks``)
stacked along a new leading axis, as the reference stacks them
(``models.bridge``). So a train state saved by either package restores in
the other. A bfloat16 leaf is written as the reference writes one: its
2-byte words as a ``'<V2'`` ``.npy`` with manifest dtype ``"bfloat16"``;
the port reads and writes those words through an int16 view of the tensor
(no ``ml_dtypes``), and the CRC is over the same bytes.

Writes go to ``step_<N>.tmp``, every file is fsync'd, then the directory is
renamed and its parent fsync'd: a crash or power loss never surfaces a torn
checkpoint; ``WRITERS`` threads stack, write and checksum the leaves.
``AsyncSaver`` copies every tensor to the host before its writer thread
starts, so the train loop may go on at once.
``restore(verify=True)`` (the default) re-checksums every leaf and raises
``ValueError`` naming a leaf whose bytes changed; float<->int casts are
refused. :func:`atomic_write_json` gives every other JSON the repo persists
(calibration tables) the same tmp + fsync + rename discipline.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import types
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

_BF16 = "bfloat16"
WRITERS = 8             # threads that write a checkpoint's leaves


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(directory: str) -> None:
    """fsync a directory entry (durability of renames/creates within it)."""
    _fsync_path(directory or ".")


def atomic_write_json(path: str, obj: Any, *, indent: Optional[int] = None
                      ) -> None:
    """Crash-safe JSON write: tmp file + flush + fsync + atomic rename +
    parent-directory fsync."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its 2-byte words
    (``'V2'``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    arr = np.asarray(leaf)
    return arr.view("V2") if arr.dtype.name == _BF16 else arr


def _leaf_parts(tree: Any, path: str = "") -> list[tuple[str, list]]:
    """(path, parts) of every leaf in the reference's order (dict keys
    sorted): a leaf outside any list is one part; a list's entries are the
    parts of its stacked leaves."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaf_parts(tree[k], _join(path, k))]
    if isinstance(tree, list):
        sub = [dict(_leaf_parts(t, path)) for t in tree]
        return [(p, [q[p] for q in sub]) for p in sub[0]]
    return [(path, tree)]


def _gather(parts) -> np.ndarray:
    """A leaf's host array: its parts stacked along new leading axes."""
    if isinstance(parts, list):
        return np.stack([_gather(p) for p in parts])
    return _host(parts)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _save_leaf(fp: str, arr: np.ndarray) -> None:
    """``np.save``, except that 2-byte words carry the reference's
    ``'<V2'`` descriptor."""
    if arr.dtype.kind != "V":
        np.save(fp, arr)
        return
    with open(fp, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def save(tree: Any, directory: str, step: int) -> str:
    """Blocking atomic save of a tree (tensors or numpy arrays). Returns
    the final checkpoint path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    def write(i_leaf):
        i, (name, parts) = i_leaf
        arr = _gather(parts)
        fn = f"leaf_{i:05d}.npy"
        fp = os.path.join(tmp, fn)
        _save_leaf(fp, arr)
        _fsync_path(fp)
        return {"path": name, "file": fn, "shape": list(arr.shape),
                "dtype": _BF16 if arr.dtype.kind == "V" else str(arr.dtype),
                "crc32": _crc(arr)}

    # leaves are stacked, written and checksummed by a pool (numpy's copies,
    # file writes and zlib release the GIL); the manifest keeps their order
    with ThreadPoolExecutor(max_workers=WRITERS) as pool:
        manifest = {"step": step, "leaves": list(pool.map(
            write, enumerate(_leaf_parts(tree))))}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(tmp)      # leaf/manifest dir entries durable before the rename
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    fsync_dir(directory)
    return final


def _snapshot(tree: Any) -> Any:
    """A host copy of every tensor (the train loop may free or replace the
    originals while the writer runs)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_snapshot(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class AsyncSaver:
    """Single background writer; joins pending work before a new save.
    ``snapshot_s`` / ``write_s`` list each save's host copy (blocking) and
    write (in the thread) seconds."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None
        self.snapshot_s: list = []
        self.write_s: list = []

    def save_async(self, tree: Any, directory: str, step: int) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_tree = _snapshot(tree)
        self.snapshot_s.append(time.perf_counter() - t0)

        def _work():
            t1 = time.perf_counter()
            self.last_path = save(host_tree, directory, step)
            self.write_s.append(time.perf_counter() - t1)

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def spec_of(tree: Any) -> Any:
    """``tree``'s structure with each tensor replaced by its shape, type
    and device (a ``restore`` template that holds no data, as the
    reference's ``ShapeDtypeStruct`` tree)."""
    if isinstance(tree, dict):
        return {k: spec_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_of(v) for v in tree]
    return types.SimpleNamespace(shape=tuple(tree.shape), dtype=tree.dtype,
                                 device=tree.device)


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _load_leaf(fp: str, dtype: str) -> np.ndarray:
    arr = np.load(fp)
    return arr.view("V2") if dtype == _BF16 else arr


def _to_tensor(arr: np.ndarray, name: str, like: torch.Tensor
               ) -> torch.Tensor:
    """A host array as a tensor of ``like``'s type on its device; float<->
    int casts refused."""
    arr = np.asarray(arr, order="C")          # keeps a 0-d leaf 0-d
    if arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if like.dtype.is_floating_point != t.dtype.is_floating_point:
        raise TypeError(
            f"{name}: refusing float<->int cast on restore (ckpt {t.dtype} "
            f"-> template {like.dtype}); re-convert the checkpoint to the "
            "template's alpha_dtype instead")
    return t.to(device=like.device, dtype=like.dtype)


def _rebuild(template: Any, by_path: dict, path: str, lead: tuple,
             step_dir: str) -> Any:
    """``template``'s structure filled from the stacked arrays: a list's
    entries take their positions ``lead`` along the leading axes."""
    if isinstance(template, dict):
        return {k: _rebuild(v, by_path, _join(path, k), lead, step_dir)
                for k, v in template.items()}
    if isinstance(template, list):
        return [_rebuild(v, by_path, path, lead + (i,), step_dir)
                for i, v in enumerate(template)]
    if path not in by_path:
        raise KeyError(f"checkpoint restore: leaf {path!r} missing from "
                       f"{step_dir}")
    arr = by_path[path]
    sub = arr[lead] if lead else arr
    if tuple(sub.shape) != tuple(template.shape):
        raise ValueError(
            f"checkpoint restore: leaf {path!r} shape mismatch — checkpoint "
            f"has {tuple(arr.shape)}, template expects "
            f"{tuple(template.shape)} at {lead}; the checkpoint was likely "
            "written for a different model config")
    return _to_tensor(sub, path, template)


def restore(directory: str, step: Optional[int] = None, *,
            template: Any = None, verify: bool = True) -> tuple[Any, int]:
    """Load a checkpoint. With ``template`` (a tree of the state's
    structure whose leaves have its shapes, types and devices: tensors, or
    ``spec_of(state)``) the leaves are mapped back by
    path, a list's entries from the stacked leaf, each cast to the
    template leaf's type on its device; without, returns ``{path: host
    array}`` (bfloat16 leaves as ``'V2'`` words). ``verify=True`` (the
    default) re-checksums every leaf against the manifest's CRC32 and
    raises ``ValueError`` naming the corrupt leaf."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {}
    for e in manifest["leaves"]:
        arr = _load_leaf(os.path.join(path, e["file"]), e["dtype"])
        if verify and "crc32" in e:
            crc = _crc(arr)
            if crc != e["crc32"]:
                raise ValueError(
                    f"checkpoint restore: leaf {e['path']!r} in {path} "
                    f"failed its CRC32 check (stored {e['crc32']:#010x}, "
                    f"read {crc:#010x}) — the file rotted on disk; restore "
                    "an older step or re-save")
        by_path[e["path"]] = arr
    if template is None:
        return by_path, step
    return _rebuild(template, by_path, "", (), path), step


def gc_old(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
