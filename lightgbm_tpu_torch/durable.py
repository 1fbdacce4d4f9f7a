"""Crash-consistent file writes and the quarantine of corrupt files: the
port's copy of what the binary cache needs from
`lightgbm_tpu/durable.py` (`atomic_write_via` :221, `quarantine` :307,
`prune_quarantined` :329). A write goes to a temporary file in the
target's directory, is flushed and fsynced, and is renamed over the
target, so a reader sees the old file or the new one, never a part. The
JAX package's retry policy, fault injection and telemetry are not
copied: a failed write raises.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

from . import log


def atomic_write_via(path: str, write_body: Callable) -> None:
    """Publish whatever `write_body(fh)` writes to `path`: temporary file
    in the same directory, body, flush, fsync, rename, and an fsync of
    the directory. On any failure the temporary file is removed and the
    error raised."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp_path = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as fh:
            write_body(fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp_path, path)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise
    try:  # the rename itself (POSIX: fsync the directory)
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def quarantine(path: str, reason: str = "") -> Optional[str]:
    """Rename a corrupt file to `<path>.corrupt` so the next run rebuilds
    from source, and prune older quarantined files of its directory to
    the newest one. Returns the new path, or None when the rename
    failed."""
    qpath = path + ".corrupt"
    try:
        os.replace(path, qpath)
    except OSError as exc:
        log.warning("Could not quarantine corrupt file %s: %s", path, exc)
        return None
    log.warning("Quarantined corrupt file %s -> %s%s; the next run "
                "rebuilds from source", path, qpath,
                " (%s)" % reason if reason else "")
    prune_quarantined(os.path.dirname(os.path.abspath(path)))
    return qpath


def prune_quarantined(directory: str) -> int:
    """Remove the `*.corrupt` files of `directory` but the newest;
    returns how many went."""
    try:
        names = [n for n in os.listdir(directory) if n.endswith(".corrupt")]
    except OSError:
        return 0
    paths = [os.path.join(directory, n) for n in names]

    def _mtime(p):
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0

    paths.sort(key=_mtime)
    removed = 0
    for p in paths[:-1]:
        try:
            os.unlink(p)
            removed += 1
        except OSError:
            pass
    return removed
