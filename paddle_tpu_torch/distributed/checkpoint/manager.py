"""CheckpointManager: atomic, async, auto-resuming step checkpoints
(port of the JAX package's ``distributed/checkpoint/manager.py``, one
process: its barriers are no-ops here, and the gang's barriers, agreed
restore step and broadcast preemption come with slice D).

Commit protocol (per step N, under ``root/``)::

    step_N.tmp/          stage: data_0.npz + metadata.json, each fsynced
    step_N/              os.replace(step_N.tmp, step_N)   (atomic rename)
    step_N/COMMITTED     marker written LAST (fsynced, atomic rename)

Only directories containing the ``COMMITTED`` marker count: ``latest_step``
/ ``restore_or_initialize`` skip torn or uncommitted directories, and GC
removes them together with committed steps beyond ``keep_last_n``.

Async saves block the train loop only for the device->host snapshot
(:func:`_collect`); serialization and IO run on a writer thread with
retry + exponential backoff on filesystem errors. One save is in flight
at a time; a background failure is re-raised on the next ``save``/
``wait`` so it cannot pass silently. ``dedupe_chunks=True`` writes each
chunk once into a content-addressed store and hard-links it into every
step that holds it.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import threading
import time
import weakref
from typing import Dict, List, Optional

from paddle_tpu_torch.testing import faults as _faults

__all__ = ["CheckpointManager"]

COMMITTED = "COMMITTED"
_STEP_RE = re.compile(r"^step_(\d+)$")

# managers with a possibly-in-flight writer thread; drained at process
# exit so a clean interpreter shutdown never tears a checkpoint
_live_managers = weakref.WeakSet()


@atexit.register
def _drain_live_managers():
    for m in list(_live_managers):
        try:
            m.wait()
        except Exception:
            pass


class CheckpointManager:
    """Manage a series of committed step checkpoints under ``root``.

    >>> mgr = CheckpointManager("/ckpt/run1", keep_last_n=3)
    >>> start = mgr.restore_or_initialize(state) or 0   # auto-resume
    >>> for step in range(start + 1, total + 1):
    ...     train_step(...)
    ...     mgr.save(step, state)                       # async commit
    ...     if mgr.reached_preemption(step):
    ...         mgr.save(step, state, block=True, force=True)
    ...         sys.exit(0)
    >>> mgr.wait()
    """

    def __init__(self, root: str, keep_last_n: int = 5,
                 async_save: bool = True, save_interval_steps: int = 1,
                 max_retries: int = 3, backoff_base: float = 0.5,
                 dedupe_chunks: bool = False):
        self._root = str(root)
        # content-addressed chunk store: every tensor chunk is written
        # once under root/chunk_cas/<content-hash>.npz and hard-linked
        # into each step directory that references it, so keep_last_n
        # retention of a mostly-frozen model costs one copy of the cold
        # layers, not keep_last_n copies.
        self._dedupe = bool(dedupe_chunks)
        # at least the newest committed step is always kept — a manager
        # that retains nothing cannot resume anything
        self._keep = max(1, int(keep_last_n))
        self._async = bool(async_save)
        self._interval = max(1, int(save_interval_steps))
        self._max_retries = int(max_retries)
        self._backoff_base = float(backoff_base)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # last_cas_hits is written by whichever root runs the save
        # (caller for block=True, the writer thread otherwise), so every
        # access goes through this lock
        self._cas_lock = threading.Lock()
        with self._cas_lock:
            self.last_cas_hits = 0
        self._preempt = None
        os.makedirs(self._root, exist_ok=True)
        self._recover_parked()
        _live_managers.add(self)

    # -- directory model -------------------------------------------------
    def _step_path(self, step: int) -> str:
        return os.path.join(self._root, f"step_{int(step)}")

    def _is_committed(self, step_dir: str) -> bool:
        return os.path.exists(os.path.join(step_dir, COMMITTED))

    def all_steps(self, include_uncommitted: bool = False) -> List[int]:
        """Steps present under root, ascending; by default only steps
        whose directory carries the COMMITTED marker."""
        out = []
        try:
            names = os.listdir(self._root)
        except FileNotFoundError:
            return out
        for name in names:
            m = _STEP_RE.match(name)
            if m is None:
                continue
            if include_uncommitted or self._is_committed(
                    os.path.join(self._root, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        if int(step) % self._interval == 0:
            return True
        return self.preemption_requested

    def save(self, step: int, state_dict: Dict, block: bool = False,
             force: bool = False) -> bool:
        """Snapshot ``state_dict`` (device→host, synchronous) and commit
        it as step ``step``. Returns False when ``save_interval_steps``
        says to skip (override with ``force=True``). ``block=True`` runs
        serialization + IO inline — the final save before an exit must
        not race process teardown."""
        if not force and not self.should_save(step):
            return False
        self.wait()  # one in flight; re-raises a prior background error
        from paddle_tpu_torch.distributed.checkpoint import _collect

        arrays, tensors_meta, data_file, objects = _collect(state_dict)
        if block or not self._async:
            self._write_and_commit(step, arrays, tensors_meta, data_file,
                                   objects)
            return True

        def runner():
            try:
                self._write_and_commit(step, arrays, tensors_meta,
                                       data_file, objects)
            except BaseException as e:  # surfaced on next save()/wait()
                # readers go through wait(), whose Thread.join() is the
                # happens-before edge for this write
                self._error = e

        self._thread = threading.Thread(
            target=runner, name=f"ckpt-writer-step{step}", daemon=True)
        self._thread.start()
        return True

    def wait(self):
        """Join any in-flight async save; raise its error if it failed."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    close = wait

    def _write_and_commit(self, step, arrays, tensors_meta, data_file,
                          objects):
        final = self._step_path(step)
        tmp = final + ".tmp"
        delay = self._backoff_base
        retries = self._max_retries
        for attempt in range(retries + 1):
            try:
                self._attempt(step, final, tmp, arrays, tensors_meta,
                              data_file, objects)
                return
            except OSError as e:
                # filesystem errors (full disk, flaky NFS) are retried
                # with exponential backoff; anything else propagates
                shutil.rmtree(tmp, ignore_errors=True)
                if attempt >= retries:
                    raise OSError(
                        f"checkpoint step {step}: write failed after "
                        f"{attempt + 1} attempts: {e}") from e
                time.sleep(delay)
                delay *= 2

    def _attempt(self, step, final, tmp, arrays, tensors_meta, data_file,
                 objects):
        from paddle_tpu_torch.distributed.checkpoint import (
            _fsync_path, _write_data,
        )

        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        if self._dedupe:
            self._write_data_cas(tmp, arrays, tensors_meta, objects)
        else:
            _write_data(tmp, arrays, tensors_meta, data_file,
                        objects=objects)
        _faults.fire(_faults.CKPT_BEFORE_COMMIT)
        aside = final + ".old"
        if os.path.isdir(final):
            if self._is_committed(final):
                # re-save of the same step (e.g. the forced
                # preemption save after an async one): keep the
                # committed copy whole until the rewrite has fully
                # landed — a kill mid-rewrite must not lose the
                # newest checkpoint
                shutil.rmtree(aside, ignore_errors=True)
                os.rename(final, aside)
            else:
                # torn rewrite from a FAILED earlier attempt: the
                # committed copy may already be parked at aside —
                # drop only the torn dir, never the parked bytes
                shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        _faults.fire(_faults.CKPT_BEFORE_MARKER)
        # marker last: its presence certifies every byte before it
        marker = os.path.join(final, COMMITTED)
        marker_tmp = marker + ".tmp"
        with open(marker_tmp, "w") as f:
            json.dump({"step": int(step), "time": time.time(),
                       "world": 1}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(marker_tmp, marker)
        _fsync_path(final)
        _fsync_path(self._root)
        shutil.rmtree(aside, ignore_errors=True)
        _faults.fire(_faults.CKPT_COMMITTED)
        self._gc(keep_step=step)

    def _write_data_cas(self, path, arrays, tensors_meta, objects):
        """Single-process content-addressed write: each chunk lands in
        ``root/chunk_cas/chunk_<hash>.npz`` once and is HARD-LINKED into
        the step directory, so identical chunks across retained steps —
        frozen embeddings, a cold adapter base — cost disk once no
        matter what ``keep_last_n`` says. The manifest references the
        per-step link (never the store), so restore stays entirely
        inside the committed directory and pruning a CAS entry can
        never tear a checkpoint. Composes with resharded restore: the
        chunk format is unchanged, only file naming and linkage differ.
        On a filesystem without hard links the write degrades to plain
        per-step copies (dedupe off, correctness identical)."""
        import hashlib

        import numpy as np

        from paddle_tpu_torch.distributed.checkpoint import (
            _META_FILE, _OBJECTS_FILE, _fsync_path,
        )
        from paddle_tpu_torch.distributed.checkpoint.metadata import (
            LocalTensorMetadata, Metadata, TensorMetadata,
        )

        cas = os.path.join(self._root, "chunk_cas")
        os.makedirs(cas, exist_ok=True)
        key_to_file = {}
        cas_hits = 0  # chunks satisfied without a fresh write
        for key, arr in arrays.items():
            hh = hashlib.blake2b(digest_size=16)
            hh.update(str(arr.dtype).encode())
            hh.update(repr(tuple(arr.shape)).encode())
            hh.update(np.ascontiguousarray(arr).tobytes())
            fname = f"chunk_{hh.hexdigest()}.npz"
            key_to_file[key] = fname
            dst = os.path.join(path, fname)
            if os.path.exists(dst):
                # identical content twice within this step (e.g. tied
                # weights saved under two names)
                cas_hits += 1
                continue
            src = os.path.join(cas, fname)
            linked = False
            if os.path.exists(src):
                try:
                    os.link(src, dst)
                    linked = True
                    cas_hits += 1
                except OSError:
                    pass  # unusable store entry; write fresh below
            if not linked:
                tmpf = dst + ".tmp"
                with open(tmpf, "wb") as f:
                    np.savez(f, data=arr)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmpf, dst)
                try:
                    os.link(dst, src)
                except FileExistsError:
                    pass  # raced a parallel save; content is identical
                except OSError:
                    pass  # no hard links here: dedupe quietly degrades
        with self._cas_lock:
            self.last_cas_hits = cas_hits
        _faults.fire(_faults.CKPT_DATA_WRITTEN)
        meta = {
            name: TensorMetadata(tm.global_shape, tm.dtype, [
                LocalTensorMetadata(c.global_offset, c.local_shape,
                                    key_to_file[c.key], "data")
                for c in tm.chunks])
            for name, tm in tensors_meta.items()
        }
        Metadata(meta).save(os.path.join(path, _META_FILE))
        _fsync_path(os.path.join(path, _META_FILE))
        if objects:
            obj_file = os.path.join(path, _OBJECTS_FILE)
            with open(obj_file, "w") as f:
                json.dump(objects, f)
                f.flush()
                os.fsync(f.fileno())

    def _recover_parked(self):
        """A crash between a same-step rewrite and its marker leaves the
        committed copy parked at ``step_N.old`` and a torn ``step_N``:
        put the committed bytes back before anything treats ``.old`` as
        garbage (runs at manager init and before every GC pass)."""
        try:
            names = os.listdir(self._root)
        except FileNotFoundError:
            return
        for name in names:
            if not name.endswith(".old") or \
                    _STEP_RE.match(name[:-4]) is None:
                continue
            parked = os.path.join(self._root, name)
            dest = os.path.join(self._root, name[:-4])
            if not self._is_committed(parked):
                continue  # uncommitted junk; GC removes it
            if self._is_committed(dest):
                # the rewrite fully landed — the parked copy is obsolete
                shutil.rmtree(parked, ignore_errors=True)
                continue
            shutil.rmtree(dest, ignore_errors=True)  # torn rewrite
            os.rename(parked, dest)

    # -- retention -------------------------------------------------------
    def _gc(self, keep_step: Optional[int] = None):
        """Remove stale staging dirs, torn/uncommitted step dirs, and
        committed steps beyond ``keep_last_n``."""
        self._recover_parked()
        committed = self.all_steps()
        for name in os.listdir(self._root):
            full = os.path.join(self._root, name)
            if name.endswith((".tmp", ".old")) and os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
                continue
            m = _STEP_RE.match(name)
            if m is None:
                continue
            step = int(m.group(1))
            torn = step not in committed
            stale = len(committed) > self._keep and \
                step in committed[:-self._keep]
            if (torn or stale) and step != keep_step:
                shutil.rmtree(full, ignore_errors=True)
        # CAS retention: a chunk whose only remaining link is the store
        # itself (st_nlink == 1) is referenced by no surviving step
        cas = os.path.join(self._root, "chunk_cas")
        if os.path.isdir(cas):
            for name in os.listdir(cas):
                full = os.path.join(cas, name)
                try:
                    if os.stat(full).st_nlink == 1:
                        os.unlink(full)
                except OSError:
                    pass  # raced another unlink / transient FS error

    # -- restore ---------------------------------------------------------
    def restore(self, state_dict: Dict, step: Optional[int] = None) -> int:
        """Fill ``state_dict`` from checkpoint ``step`` (default: newest
        committed): tensors in place on their devices, other leaves
        replaced (``load_state_dict``). Refuses an uncommitted step."""
        from paddle_tpu_torch.distributed.checkpoint import load_state_dict

        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self._root!r}")
        path = self._step_path(step)
        if not self._is_committed(path):
            raise ValueError(
                f"checkpoint step {step} at {path!r} has no COMMITTED "
                f"marker: refusing to restore from a torn save")
        load_state_dict(state_dict, path)
        return int(step)

    def restore_or_initialize(self, state_dict: Dict) -> Optional[int]:
        """Auto-resume: restore the newest committed checkpoint and
        return its step, or return None (leaving ``state_dict``
        untouched) when none exists. Torn/uncommitted directories are
        skipped, never read."""
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(state_dict, step)

    # -- preemption ------------------------------------------------------
    def install_preemption_handler(self, signals=None):
        """Capture SIGTERM (the cloud preemption notice): sets a flag the
        train loop polls via :meth:`reached_preemption`, then takes its
        final synchronous save and exits."""
        from paddle_tpu_torch.distributed.watchdog import preemption_monitor

        self._preempt = preemption_monitor()
        self._preempt.install(signals)
        return self._preempt

    @property
    def preemption_requested(self) -> bool:
        if self._preempt is None:
            return False
        return self._preempt.requested()

    def reached_preemption(self, step: int) -> bool:
        """Poll between steps; True once a preemption notice arrived.
        The caller then does ``save(step, state, block=True,
        force=True)`` and exits 0, as the class docstring's loop does."""
        return self.preemption_requested
