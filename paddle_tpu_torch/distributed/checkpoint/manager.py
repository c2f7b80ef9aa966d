"""CheckpointManager: atomic, async, auto-resuming step checkpoints
(port of the JAX package's ``distributed/checkpoint/manager.py``). A
restore's ``target_layout`` lands each named tensor as this rank's
shard.

Commit protocol (per step N, under ``root/``)::

    step_N.tmp/          stage: data_*.npz + metadata.json, each fsynced
    step_N/              os.replace(step_N.tmp, step_N)   (atomic rename)
    step_N/COMMITTED     marker written LAST (fsynced, atomic rename)

Only directories containing the ``COMMITTED`` marker count: ``latest_step``
/ ``restore_or_initialize`` skip torn or uncommitted directories, and GC
removes them together with committed steps beyond ``keep_last_n``.

Async saves block the train loop only for the device->host snapshot
(:func:`_collect`); serialization and IO run on a writer thread with
retry + exponential backoff on filesystem errors. One save is in flight
at a time; a background failure is re-raised on the next ``save``/
``wait`` so it cannot pass silently. ``dedupe_chunks=True`` (one
process only) writes each chunk once into a content-addressed store and
hard-links it into every step that holds it.

In a world of several ranks every rank stages its own shards, behind
the world's store barriers (a fresh namespace per save, so async saves
run there too; a gloo collective cannot run on the writer thread), and
rank 0 alone commits, recovers and collects garbage. A save gets one
attempt there (a lone retrying rank would wait in barriers its peers
never reach), and a rank whose part fails posts it, so every rank's
save raises instead of waiting out the barrier. A restore takes rank
0's newest committed step on every rank (``_agreed_latest_step``), and
:meth:`CheckpointManager.reached_preemption` broadcasts rank 0's notice
at the save boundaries, so every rank takes its final save at the same
step. The manager assumes ONE writer per process.
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

# the package imports this module last, once these are defined
from paddle_tpu_torch.distributed.checkpoint import (
    _namespace, _world, post_failure, store_barrier,
)
from paddle_tpu_torch.testing import faults as _faults

__all__ = ["CheckpointManager"]


def _broadcast_int(value: int) -> int:
    """Rank 0's ``value`` on every rank of the world (a collective on the
    default group, on this rank's device: the main thread only)."""
    import torch

    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.distributed.env import current_device

    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=current_device())
    comm.broadcast_(t, src=0)
    return int(t.item())

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

    def _agreed_latest_step(self) -> Optional[int]:
        """A restore must use ONE step on every rank, and the ranks' own
        listings can disagree (rank 0's recovery renames race the peers'
        listdir; a shared filesystem can show a new commit to some ranks
        first), so rank 0's view, the view of the rank that recovers and
        collects garbage, is broadcast and wins. Peers also wait here
        until rank 0 has finished its recovery."""
        step = self.latest_step()
        if _world()[1] == 1:
            return step
        got = _broadcast_int(-1 if step is None else int(step))
        return None if got < 0 else got

    # -- save ------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        if int(step) % self._interval == 0:
            return True
        # one process only: saves are collective, and the local notice
        # can differ across ranks for a poll interval; a lone rank saving
        # off the schedule would wait alone in the barriers. A gang's
        # preemption save goes through reached_preemption()
        return _world()[1] == 1 and self.preemption_requested

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

        arrays, tensors_meta, data_file, objects, replicas = \
            _collect(state_dict)
        # a fresh store-barrier namespace for this save (counted alike on
        # every rank: saves are collective)
        ns = _namespace()
        if block or not self._async:
            self._write_and_commit(step, arrays, tensors_meta, data_file,
                                   objects, replicas, ns)
            return True

        def runner():
            try:
                self._write_and_commit(step, arrays, tensors_meta,
                                       data_file, objects, replicas, ns)
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
                          objects, replicas, ns):
        final = self._step_path(step)
        tmp = final + ".tmp"
        delay = self._backoff_base
        world = _world()[1]
        # retries are per-process decisions: in a gang a lone retrying
        # rank would wait in barriers its peers never reach, so a
        # multi-rank save gets one attempt
        retries = self._max_retries if world == 1 else 0
        fail = f"ckpt_{ns}_failed"

        def barrier(tag):
            store_barrier(f"ckpt_{ns}_{tag}", fail)

        for attempt in range(retries + 1):
            try:
                self._attempt(step, final, tmp, arrays, tensors_meta,
                              data_file, objects, replicas, barrier,
                              attempt)
                return
            except BaseException as e:
                if world > 1:
                    post_failure(fail, e)
                if not isinstance(e, OSError):
                    raise
                # filesystem errors (full disk, flaky NFS) are retried
                # with exponential backoff; anything else propagates
                if _world()[0] == 0:
                    shutil.rmtree(tmp, ignore_errors=True)
                if attempt >= retries:
                    raise OSError(
                        f"checkpoint step {step}: write failed after "
                        f"{attempt + 1} attempts: {e}") from e
                time.sleep(delay)
                delay *= 2

    def _attempt(self, step, final, tmp, arrays, tensors_meta, data_file,
                 objects, replicas, barrier, attempt):
        from paddle_tpu_torch.distributed.checkpoint import _write_data

        rank, world = _world()

        def tagged(tag):
            barrier(f"{tag}:a{attempt}")

        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
        if world > 1:
            tagged(f"{step}_stage")
        if self._dedupe and world == 1:
            self._write_data_cas(tmp, arrays, tensors_meta, objects)
        else:
            _write_data(tmp, arrays, tensors_meta, data_file,
                        barrier=tagged, objects=objects, replicas=replicas)
        if rank == 0:
            self._commit(step, final, tmp, world)
        if world > 1:
            tagged(f"{step}_done")
        self._gc(keep_step=step)

    def _commit(self, step, final, tmp, world):
        """Rank 0: move the staged step into place and mark it."""
        from paddle_tpu_torch.distributed.checkpoint import _fsync_path

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
                       "world": int(world)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(marker_tmp, marker)
        _fsync_path(final)
        _fsync_path(self._root)
        shutil.rmtree(aside, ignore_errors=True)
        _faults.fire(_faults.CKPT_COMMITTED)

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
        garbage (runs at manager init and before every GC pass; rank 0
        only)."""
        if _world()[0] != 0:
            return
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
        """Remove (rank 0 only): stale staging dirs, torn/uncommitted
        step dirs, and committed steps beyond ``keep_last_n``."""
        if _world()[0] != 0:
            return
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
    def restore(self, state_dict: Dict, step: Optional[int] = None,
                target_layout: Optional[Dict] = None,
                rank: Optional[int] = None) -> int:
        """Fill ``state_dict`` from checkpoint ``step`` (default: newest
        committed): tensors in place on their devices, other leaves
        replaced (``load_state_dict``). Refuses an uncommitted step.

        ``target_layout`` maps flat state-dict names ('/'-joined paths)
        to :class:`~paddle_tpu_torch.distributed.redistribute.Layout`
        placements: each such tensor receives this rank's shard of the
        stored global tensor (``rank``, default: the rank in the default
        ``torch.distributed`` group, 0 without one), filled in place when
        it has the shard's shape, rebound to it when it has the global
        one: a checkpoint written unsharded lands on a TP engine's
        shards. The JAX package re-places each tensor on its devices
        before the load (``devices=``); here a process holds one rank.
        An unknown name raises ``KeyError``, a non-tensor leaf
        ``TypeError``, a layout that does not tile the stored shape
        ``ValueError``."""
        from paddle_tpu_torch.distributed.checkpoint import load_state_dict

        if step is None:
            step = self._agreed_latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self._root!r}")
        path = self._step_path(step)
        if not self._is_committed(path):
            raise ValueError(
                f"checkpoint step {step} at {path!r} has no COMMITTED "
                f"marker: refusing to restore from a torn save")
        shards = None
        if target_layout:
            shards = self._target_shards(state_dict, target_layout, rank)
        load_state_dict(state_dict, path, shards=shards)
        return int(step)

    @staticmethod
    def _target_shards(state_dict: Dict, target_layout: Dict,
                       rank: Optional[int]) -> Dict:
        """``target_layout`` checked against the state dict, as ``name ->
        (layout, this rank's shard index)``."""
        import torch

        from paddle_tpu_torch.distributed.checkpoint import _flatten

        flat = _flatten(state_dict)
        unknown = [n for n in target_layout if n not in flat]
        if unknown:
            raise KeyError(
                f"target_layout names absent from the state dict: "
                f"{unknown[:8]}" + ("..." if len(unknown) > 8 else ""))
        for name in target_layout:
            if not isinstance(flat[name], torch.Tensor):
                raise TypeError(
                    f"target_layout entry {name!r} is not a Tensor "
                    f"leaf (got {type(flat[name]).__name__})")
        if rank is None:
            import torch.distributed as dist

            rank = (dist.get_rank() if dist.is_available()
                    and dist.is_initialized() else 0)
        rank = int(rank)
        out = {}
        for name, lay in target_layout.items():
            if lay.size > 1 and not 0 <= rank < lay.size:
                raise ValueError(
                    f"target_layout entry {name!r} has {lay.size} shards, "
                    f"rank {rank} holds none")
            out[name] = (lay, rank if lay.size > 1 else 0)
        return out

    def restore_or_initialize(self, state_dict: Dict,
                              target_layout: Optional[Dict] = None,
                              rank: Optional[int] = None) -> Optional[int]:
        """Auto-resume: restore the newest committed checkpoint and
        return its step, or return None (leaving ``state_dict``
        untouched) when none exists. Torn/uncommitted directories are
        skipped, never read. ``target_layout`` and ``rank`` shard the
        restore as in :meth:`restore`. In a gang every rank restores rank
        0's newest committed step."""
        step = self._agreed_latest_step()
        if step is None:
            return None
        return self.restore(state_dict, step, target_layout=target_layout,
                            rank=rank)

    # -- preemption ------------------------------------------------------
    def install_preemption_handler(self, signals=None):
        """Capture SIGTERM (the cloud preemption notice): sets a flag the
        train loop polls via :meth:`reached_preemption` and broadcasts
        the notice through the gang store, so that every rank takes its
        final synchronous save and exits together."""
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
        """Poll between steps; True once a preemption notice (a local
        SIGTERM or a peer's store broadcast) has arrived. The caller then
        does ``save(step, state, block=True, force=True)`` and exits 0,
        as the class docstring's loop does.

        In a gang every rank must act at the SAME step boundary, or the
        final save waits on unmatched barriers: rank 0's view is
        broadcast (a collective on the world group) at every
        ``save_interval_steps`` boundary, where a save already pays a
        device->host snapshot. A notice on any rank reaches rank 0
        through the store within a poll interval, so the final save comes
        at most one interval later: budget ``--stop_timeout`` for it."""
        if _world()[1] == 1:
            return self.preemption_requested
        if int(step) % self._interval != 0:
            return False
        return bool(_broadcast_int(1 if self.preemption_requested else 0))
