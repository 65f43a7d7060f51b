"""Crash-safe JSON writes (port of ``repro.checkpoint.ckpt``, trimmed to
``atomic_write_json`` and ``fsync_dir``, what ``runtime.calibrate`` saves
its tables with; the checkpoint format is ROADMAP A.8).

A write goes to ``<path>.tmp``, is flushed and fsync'd, renamed over
``path``, and the parent directory entry is fsync'd after the rename, so a
crash or a power loss leaves the old complete file or the new complete
file, never a torn one.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional


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
