"""Checkpoint and resume: asynchronous, preemption-aware, self-verifying.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.utils.checkpoint`, with
``torch.save`` (loaded with ``weights_only=True``) in place of Orbax.  The
whole train state is saved: the model's parameters and buffers, the
momentum, each rank's EF residual, the compressor state, the guard state,
the adaptive controller's state, the step and the seed (the seed and the step give every random stream,
``train/state.py``).

A step is the directory ``<dir>/<step>/`` holding ``state.pt`` (rank 0's:
the step, seed, compressor, guard and controller state, and the model and momentum
when every rank holds the same) and one ``rank<r>.pt`` a rank (its EF
residual, and its model shard and momentum under ``sharded_model``, the
LM's ``--tp`` / ``--pp``).  Every rank writes its file into
``<dir>/.pending-<run>-<n>/`` (``<run>`` a token rank 0 draws and
broadcasts when the Checkpointer is made, ``<n>`` the save's number, the
same on every rank since every rank saves in one order); rank 0 waits until
the world's files are there (a barrier on the file system, so a background
writer issues no collective beside the step loop's), renames the directory
to ``<dir>/<step>`` and commits the manifest.  The manifest is the JAX
package's: ``manifest-<step>.json`` at the directory's root, schema
:data:`MANIFEST_SCHEMA`, keys ``v/step/ts/files/meta``, a SHA-256 and a
size a file, so the JAX package's ``verify_step_dir`` checks a port
directory too.

  * :meth:`Checkpointer.save_async` copies the state to host memory before
    it returns (the next step updates the parameters, momentum and EF in
    place) and writes in a background thread; the next save, restore or
    :meth:`~Checkpointer.drain` waits for it, and the wait accrues to
    ``ckpt/blocked_ms``.
  * :meth:`Checkpointer.restore` with no step walks newest to oldest past
    steps that fail verification or loading; the walk-back accrues to
    ``ckpt/rollback_steps``.  A checkpoint of another world or mesh is
    refused (:class:`LayoutMismatch`): the JAX ``Checkpointer`` restores
    onto the target's layout too, and its EF carries the world on its
    leading axis, so neither package restores across worlds.
  * ``events`` (``obs/export.EventStream``) gets ``ckpt_save`` and
    ``ckpt_rollback`` records, ``flight`` (``obs/flight.FlightRecorder``)
    the same in its ``ckpt`` ring, and a blackbox dump when a checkpoint
    fails verification (an explicit step, or a walk-back that finds
    nothing verifiable), as in the JAX ``Checkpointer``.
  * :meth:`Checkpointer.follow_world`: after an elastic remesh or readmit
    (``train/elastic.py``) the rank, the world and the layout follow the
    new world, so the saves after the transition are written at its size
    and a later ``--resume`` at that size restores them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.control.state import control_from_dict, control_to_dict
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.train.guard import guard_from_dict, guard_to_dict

__all__ = [
    "Checkpointer", "CheckpointCorrupt", "LayoutMismatch", "save_checkpoint",
    "restore_checkpoint", "MANIFEST_SCHEMA", "manifest_path", "read_manifest",
    "write_manifest", "verify_step_dir", "list_step_dirs", "digest_file",
]

#: manifest schema version (the JAX package's)
MANIFEST_SCHEMA = 1
#: how long rank 0 waits for the world's rank files before it commits a step
_WORLD_FILES_WAIT_S = 600.0


class CheckpointCorrupt(RuntimeError):
    """A checkpoint step failed manifest verification."""


class LayoutMismatch(NotImplementedError):
    """The checkpoint was written by another world size or mesh."""


def manifest_path(directory: str, step: int) -> str:
    """``manifest-<step>.json`` at the directory's root."""
    return os.path.join(directory, f"manifest-{int(step)}.json")


def digest_file(path: str) -> str:
    """Chunked SHA-256 of one file."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(directory: str, step: int, meta: Optional[Dict[str, Any]] = None) -> str:
    """Hash every file under ``<directory>/<step>`` and commit the manifest
    atomically (tmp + ``os.replace``)."""
    step = int(step)
    step_dir = os.path.join(directory, str(step))
    files: Dict[str, Dict[str, Any]] = {}
    for root, _, names in os.walk(step_dir):
        for name in sorted(names):
            fp = os.path.join(root, name)
            files[os.path.relpath(fp, step_dir)] = {"sha256": digest_file(fp),
                                                    "bytes": os.path.getsize(fp)}
    rec = {"v": MANIFEST_SCHEMA, "step": step, "ts": time.time(), "files": files,
           "meta": dict(meta or {})}
    path = manifest_path(directory, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)
    return path


def read_manifest(directory: str, step: int) -> Optional[Dict[str, Any]]:
    """A step's manifest; ``None`` when missing or unreadable."""
    try:
        with open(manifest_path(directory, step), "rb") as f:
            rec = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


def verify_step_dir(directory: str, step: int) -> List[str]:
    """Verify one step against its manifest; problem strings (empty =
    verifiable).  A step with no manifest is a legacy checkpoint and passes;
    a manifest that cannot be parsed is a problem."""
    step = int(step)
    step_dir = os.path.join(directory, str(step))
    if not os.path.isdir(step_dir):
        return [f"step directory missing: {step_dir}"]
    man = read_manifest(directory, step)
    if man is None:
        if os.path.exists(manifest_path(directory, step)):
            return ["manifest unreadable (torn commit?)"]
        return []
    if man.get("v") != MANIFEST_SCHEMA:
        return [f"manifest schema {man.get('v')!r} != {MANIFEST_SCHEMA}"]
    problems = []
    for rel, ent in (man.get("files") or {}).items():
        fp = os.path.join(step_dir, rel)
        if not os.path.isfile(fp):
            problems.append(f"missing file: {rel}")
        elif os.path.getsize(fp) != int(ent.get("bytes", -1)):
            problems.append(f"size mismatch: {rel} ({os.path.getsize(fp)} != "
                            f"{ent.get('bytes')})")
        elif digest_file(fp) != ent.get("sha256"):
            problems.append(f"digest mismatch: {rel}")
    return problems


def list_step_dirs(directory: str) -> List[int]:
    """Step indices present on disk (numeric subdirectories), sorted."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


def _host(tree: Any) -> Any:
    """A host copy of a tree of tensors (never a view of the live state)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def _marker(tree: Any) -> Dict[str, Any]:
    """``()`` (the feature off) as the empty marker ``{}``, else ``{'on': tree}``."""
    return {} if isinstance(tree, tuple) and tree == () else {"on": tree}


def _placed(saved: Any, like: Any) -> Any:
    """``saved`` on the devices of ``like`` (a tree of the same layout)."""
    if isinstance(saved, dict):
        if not isinstance(like, dict) or set(saved) != set(like):
            raise ValueError("checkpoint tree does not match the state's keys")
        return {k: _placed(saved[k], like[k]) for k in like}
    if isinstance(saved, torch.Tensor):
        if not isinstance(like, torch.Tensor) or saved.shape != like.shape:
            raise ValueError("checkpoint tensor does not match the state's shape")
        return saved.to(device=like.device, dtype=like.dtype)
    return saved


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class Checkpointer:
    """A step-indexed checkpoint directory: best-metric gating, asynchronous
    writes, checksummed manifests and walk-back restore.

    ``rank`` / ``world`` default to the process group's; ``sharded_model``
    puts the model and momentum in each rank's file; ``layout`` (default
    ``{'world': world}``) is what a restore must match.  One Checkpointer
    a rank owns the directory; ``events`` / ``flight`` are the telemetry
    hooks (the harnesses set them under ``--events`` / ``--flight_dir``),
    ``stream`` the delta stream's ``StreamWriter`` (each committed save
    requests a stream keyframe; a failure there never fails the save).
    ``token`` names the pending directories without the broadcast that
    draws one (a worker joining a running world takes the survivors' from
    :meth:`follow_world`).
    """

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = 3,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 sharded_model: bool = False, layout: Optional[Dict[str, Any]] = None,
                 token: Optional[str] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.rank = mesh.rank() if rank is None else int(rank)
        self.world = mesh.world() if world is None else int(world)
        self.sharded_model = sharded_model
        self.layout = {"world": self.world, **(layout or {})}
        self.max_to_keep = max_to_keep
        self.best_metric: Optional[float] = None
        #: the pinned step of the best checkpoint; GC never evicts it
        self.best_step: Optional[int] = None
        self.events = None
        self.flight = None
        #: the delta stream tee: each committed save requests a keyframe, so
        #: a stream consumer's recovery never spans a checkpoint
        self.stream = None
        #: the last background write failure a non-raising barrier popped
        self.last_save_error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._bg_error: Optional[BaseException] = None
        self._op = threading.RLock()
        self._mx = threading.Lock()
        self._inflight = 0
        self._save_ms = 0.0       # duration of the newest committed write
        self._blocked_ms = 0.0    # the step loop's time in barriers, summed
        self._rollback_steps = 0  # restore walk-back distance, summed
        self._last_step: Optional[int] = None
        self._mark_mono = time.monotonic()
        # this run's pending-directory token, the same on every rank (a
        # collective: every rank makes its Checkpointers in one order)
        drawn = [uuid.uuid4().hex[:12]]
        if (token is None and self.world > 1 and dist.is_initialized()
                and dist.get_world_size() == self.world):
            dist.broadcast_object_list(drawn, src=0)
        self._token = drawn[0] if token is None else token
        self._saves = 0
        # set by follow_world: rank 0's wait for a gone world's files ends
        self._abandon = threading.Event()

    # ------------------------------------------------------------------ saves

    def _snapshot(self, state) -> Tuple[Optional[Dict[str, Any]], Dict[str, Any]]:
        """``(rank 0's replicated part or None, this rank's part)`` as host
        copies."""
        mine: Dict[str, Any] = {"ef": _marker(_host(state.ef))}
        rep = None
        want_model = self.sharded_model or self.rank == 0
        model = ({k: v.detach().to("cpu", copy=True)
                  for k, v in state.model.state_dict().items()} if want_model else None)
        opt = _host(state.opt_state) if want_model else None
        if self.sharded_model:
            mine.update(model=model, opt_state=opt)
        if self.rank == 0:
            rep = {"step": int(state.step), "seed": int(state.seed),
                   "comp": _marker(_host(state.comp)),
                   "guard": _marker(guard_to_dict(state.guard) if state.guard != () else ()),
                   "control": _marker(control_to_dict(state.control)
                                      if state.control != () else ()),
                   "layout": dict(self.layout)}
            if not self.sharded_model:
                rep.update(model=model, opt_state=opt)
        return rep, mine

    def _pending(self) -> str:
        """The next save's pending directory (one a save, in save order)."""
        self._saves += 1
        return os.path.join(self.directory, f".pending-{self._token}-{self._saves}")

    def save(self, state, meta: Optional[Dict[str, Any]] = None) -> int:
        """Synchronous save: wait for any write in flight, then write; on
        rank 0 the step is committed when this returns."""
        self._barrier(accrue=True)
        step = int(state.step)
        meta = self._meta_with_best(meta)
        rep, mine = self._snapshot(state)
        pending = self._pending()
        t0 = time.monotonic()
        if self._write_payload(pending, step, rep, mine, meta):
            self._committed(step, (time.monotonic() - t0) * 1e3, mode="sync", meta=meta)
        return step

    def save_async(self, state, meta: Optional[Dict[str, Any]] = None) -> int:
        """Copy the state to host memory, hand the write to a background
        thread and return.  A write still in flight is waited for first
        (``ckpt/blocked_ms``); a background failure is raised at the next
        barrier."""
        self._barrier(accrue=True)
        step = int(state.step)
        meta = self._meta_with_best(meta)
        rep, mine = self._snapshot(state)
        pending = self._pending()
        with self._mx:
            self._inflight = 1

        def _bg():
            t0 = time.monotonic()
            try:
                committed = self._write_payload(pending, step, rep, mine, meta)
            except BaseException as e:  # surfaced at the next barrier
                with self._mx:
                    self._bg_error = e
            else:
                if committed:
                    self._committed(step, (time.monotonic() - t0) * 1e3, mode="async",
                                    meta=meta)
            finally:
                with self._mx:
                    self._inflight = 0

        self._thread = threading.Thread(target=_bg, name=f"ckpt-save-{step}", daemon=True)
        self._thread.start()
        return step

    def save_if_best(self, state, metric: float, *, floor: float = 0.0,
                     meta: Optional[Dict[str, Any]] = None) -> bool:
        """Save when ``metric`` beats the best so far and reaches ``floor``;
        the saved step is pinned against GC."""
        if metric < floor or (self.best_metric is not None and metric <= self.best_metric):
            return False
        self.best_metric = metric
        self.best_step = int(state.step)
        self.save(state, {**(meta or {}), "best_metric": metric})
        return True

    def _meta_with_best(self, meta: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        meta = dict(meta or {})
        if self.best_metric is not None:
            meta.setdefault("best_metric", self.best_metric)
        if self.best_step is not None:
            meta.setdefault("best_step", int(self.best_step))
        return meta

    def _write_payload(self, pending: str, step: int, rep, mine, meta: Dict[str, Any]) -> bool:
        """Write this rank's file into ``pending``; on rank 0 wait for the
        world's, commit the step and collect garbage.  True where this call
        committed."""
        os.makedirs(pending, exist_ok=True)
        _atomic_save(mine, os.path.join(pending, f"rank{self.rank}.pt"))
        if self.rank != 0:
            return False
        _atomic_save(rep, os.path.join(pending, "state.pt"))
        want = [os.path.join(pending, f"rank{r}.pt") for r in range(self.world)]
        deadline = time.monotonic() + _WORLD_FILES_WAIT_S
        while not all(os.path.exists(p) for p in want):
            if self._abandon.is_set():
                raise RuntimeError(f"checkpoint step {step}: abandoned, its world changed "
                                   "before every rank's file arrived")
            if time.monotonic() > deadline:
                raise TimeoutError(f"checkpoint step {step}: the world's rank files did not "
                                   f"arrive within {_WORLD_FILES_WAIT_S:g} s")
            time.sleep(0.01)
        with self._op:
            final = os.path.join(self.directory, str(step))
            if (os.path.isdir(final) and read_manifest(self.directory, step) is not None
                    and not verify_step_dir(self.directory, step)):
                # the same step, already committed and verifiable
                shutil.rmtree(pending, ignore_errors=True)
            else:
                if os.path.isdir(final):
                    shutil.rmtree(final)
                    self._rm_manifest(step)
                os.replace(pending, final)
                write_manifest(self.directory, step, meta={**meta, "layout": self.layout})
            self._gc()
        return True

    def _committed(self, step: int, ms: float, *, mode: str, meta: Dict[str, Any]) -> None:
        with self._mx:
            self._save_ms = ms
            self._last_step = step
            self._mark_mono = time.monotonic()
        fields = {"step": step, "ms": round(ms, 3), "mode": mode}
        if meta.get("emergency"):
            fields["emergency"] = True
        self._emit("ckpt_save", **fields)
        st = self.stream
        if st is not None:
            try:
                st.request_keyframe()  # re-anchor the delta window here
            except Exception:
                pass  # the stream tee must never fail a save

    def _gc(self) -> None:
        """Keep the newest ``max_to_keep`` steps and the pinned best; drop
        the pending directories of earlier runs and earlier saves."""
        for name in os.listdir(self.directory):
            if not name.startswith(".pending-"):
                continue
            token, _, n = name[len(".pending-"):].rpartition("-")
            if token != self._token or (n.isdigit() and int(n) < self._saves):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        if not self.max_to_keep or self.max_to_keep <= 0:
            return
        steps = list_step_dirs(self.directory)
        keep = set(steps[-self.max_to_keep:])
        if self.best_step is not None:
            keep.add(int(self.best_step))
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)
                self._rm_manifest(s)

    def _rm_manifest(self, step: int) -> None:
        try:
            os.remove(manifest_path(self.directory, step))
        except OSError:
            pass

    # --------------------------------------------------------------- barriers

    def _barrier(self, *, accrue: bool, raise_error: bool = True) -> None:
        t = self._thread
        if t is not None:
            was_alive = t.is_alive()
            t0 = time.monotonic()
            t.join()
            if accrue and was_alive:
                with self._mx:
                    self._blocked_ms += (time.monotonic() - t0) * 1e3
            self._thread = None
        err, self._bg_error = self._bg_error, None
        if err is not None:
            self.last_save_error = err
            if raise_error:
                raise err

    def follow_world(self, rank: int, world: int, *, layout: Optional[Dict[str, Any]] = None,
                     sequence: Optional[Tuple[str, int]] = None) -> None:
        """Move to a new world after an elastic transition: a write in flight
        is abandoned where it still waits for a gone world's files (its
        failure goes to ``last_save_error``), and later saves are written by
        ``rank`` of ``world``, under ``layout`` (default: the old one's keys
        with the new world).  ``sequence`` (:meth:`sequence` of a survivor)
        makes a joiner's pending directories the survivors'."""
        self._abandon.set()
        try:
            self._barrier(accrue=False, raise_error=False)
        finally:
            self._abandon.clear()
        self.rank, self.world = int(rank), int(world)
        self.layout = {**self.layout, **(layout or {}), "world": self.world}
        if sequence is not None:
            self._token, self._saves = str(sequence[0]), int(sequence[1])

    def sequence(self) -> Tuple[str, int]:
        """``(token, saves)``: what names the next pending directory."""
        return self._token, self._saves

    def drain(self, *, raise_error: bool = True) -> None:
        """Wait for any write in flight; with ``raise_error=False`` (the
        emergency path) a failure goes to ``last_save_error``."""
        self._barrier(accrue=True, raise_error=raise_error)

    # ---------------------------------------------------------------- restore

    def latest_step(self) -> Optional[int]:
        steps = list_step_dirs(self.directory)
        return steps[-1] if steps else None

    def verify_step(self, step: int) -> List[str]:
        return verify_step_dir(self.directory, step)

    def restore(self, target_state, step: Optional[int] = None):
        """Restore into ``target_state`` (its model and momentum in place,
        on their devices); returns ``(state, meta)``.

        With ``step`` the manifest must verify, else
        :class:`CheckpointCorrupt`.  Without, the steps are walked newest to
        oldest past those that fail verification or loading; only when none
        restores does the first error propagate.  A checkpoint of another
        layout raises :class:`LayoutMismatch` at once."""
        self._barrier(accrue=False, raise_error=False)
        if step is not None:
            problems = verify_step_dir(self.directory, int(step))
            if problems:
                err = CheckpointCorrupt(f"checkpoint step {int(step)} failed verification: "
                                        + "; ".join(problems))
                self._observe_corrupt(err, step=int(step))
                raise err
            return self._restore_step(target_state, int(step))
        steps = sorted(list_step_dirs(self.directory), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory!r}")
        newest = steps[0]
        first_err: Optional[BaseException] = None
        skipped: List[Dict[str, Any]] = []
        for s in steps:
            problems = verify_step_dir(self.directory, s)
            if problems:
                if first_err is None:
                    first_err = CheckpointCorrupt(f"checkpoint step {s} failed verification: "
                                                  + "; ".join(problems))
                skipped.append({"step": s, "problems": problems})
                continue
            try:
                out = self._restore_step(target_state, s)
            except LayoutMismatch:
                raise
            except Exception as e:
                if first_err is None:
                    first_err = e
                skipped.append({"step": s, "problems": [repr(e)]})
                continue
            if s != newest:
                rollback = newest - s
                with self._mx:
                    self._rollback_steps += rollback
                self._emit("ckpt_rollback", from_step=newest, to_step=s,
                           rollback_steps=rollback, skipped=skipped)
            return out
        if isinstance(first_err, CheckpointCorrupt):
            # the walk-back exhausted the chain: nothing on disk verifies
            self._observe_corrupt(first_err, step=newest)
        raise first_err

    def _restore_step(self, target, step: int):
        step_dir = os.path.join(self.directory, str(step))
        rep = torch.load(os.path.join(step_dir, "state.pt"), map_location="cpu",
                         weights_only=True)
        if rep.get("layout") != self.layout:
            raise LayoutMismatch(
                f"checkpoint step {step} was written by {rep.get('layout')}, this run is "
                f"{self.layout}: a checkpoint restores only onto the layout that wrote it "
                "(the JAX Checkpointer restores onto the target's layout too)")
        mine = torch.load(os.path.join(step_dir, f"rank{self.rank}.pt"), map_location="cpu",
                          weights_only=True)
        src = mine if self.sharded_model else rep
        sd, live = src["model"], target.model.state_dict()
        if set(sd) != set(live) or any(sd[k].shape != live[k].shape for k in live):
            raise ValueError(f"checkpoint step {step} does not match the model's tensors")
        opt = _placed(src["opt_state"], target.opt_state)
        ef = _placed(mine["ef"]["on"], target.ef) if "on" in mine["ef"] else ()
        if (ef == ()) != (isinstance(target.ef, tuple) and target.ef == ()):
            raise ValueError(f"checkpoint step {step} and the state disagree on error feedback")
        # a saved compressor / guard state wins; the empty marker (off at
        # save time) keeps the caller's
        comp = (_placed(rep["comp"]["on"], target.comp) if "on" in rep["comp"]
                and isinstance(target.comp, dict) else target.comp)
        guard = guard_from_dict(rep["guard"]["on"]) if "on" in rep["guard"] else target.guard
        # the JAX legacy rule: a step saved without control (or before the
        # controller existed) restores with the caller's fresh state
        control = rep.get("control") or {}
        control = control_from_dict(control["on"]) if "on" in control else target.control
        # every check passed: now write into the live model and momentum
        target.model.load_state_dict(sd)
        _copy_into(target.opt_state, opt)
        man = read_manifest(self.directory, step) or {}
        meta = {k: v for k, v in (man.get("meta") or {}).items() if k != "layout"}
        if "best_metric" in meta:
            self.best_metric = float(meta["best_metric"])
        if "best_step" in meta:
            self.best_step = int(meta["best_step"])
        state = dataclasses.replace(target, step=int(rep["step"]), seed=int(rep["seed"]),
                                    ef=ef, comp=comp, guard=guard, control=control)
        return state, meta

    # ---------------------------------------------------------- observability

    def metrics(self) -> Dict[str, float]:
        """The ``ckpt/*`` gauges and counters (the JAX keys)."""
        with self._mx:
            return {
                "ckpt/save_ms": self._save_ms,
                "ckpt/blocked_ms": self._blocked_ms,
                "ckpt/inflight": float(self._inflight),
                "ckpt/last_step": float(-1 if self._last_step is None else self._last_step),
                "ckpt/age_s": time.monotonic() - self._mark_mono,
                "ckpt/rollback_steps": float(self._rollback_steps),
            }

    def heartbeat_fields(self) -> Dict[str, float]:
        """The fields a watchdog's checkpoint-age check reads."""
        with self._mx:
            return {
                "last_ckpt_step": int(-1 if self._last_step is None else self._last_step),
                "ckpt_age_s": time.monotonic() - self._mark_mono,
            }

    def _emit(self, kind: str, **fields) -> None:
        fl = self.flight
        if fl is not None:
            try:
                fl.record("ckpt", kind, **fields)
            except Exception:
                pass  # telemetry must never fail a save/restore
        ev = self.events
        if ev is None:
            return
        try:
            ev.emit(kind, **fields)
        except Exception:
            pass  # telemetry must never fail a save/restore

    def _observe_corrupt(self, err: BaseException, *, step: int) -> None:
        fl = self.flight
        if fl is None:
            return
        try:
            fl.observe(err, step=step)
        except Exception:
            pass  # forensics must never mask the corruption itself

    def close(self) -> None:
        """Drain the background writer, never raising."""
        self._barrier(accrue=False, raise_error=False)


@torch.no_grad()
def _copy_into(live: Any, saved: Any) -> None:
    if isinstance(live, dict):
        for k in live:
            _copy_into(live[k], saved[k])
    elif isinstance(live, torch.Tensor):
        live.copy_(saved)


def save_checkpoint(directory: str, state, meta: Optional[Dict] = None, **kw) -> int:
    """One-shot synchronous save."""
    ckpt = Checkpointer(directory, **kw)
    try:
        return ckpt.save(state, meta)
    finally:
        ckpt.close()


def restore_checkpoint(directory: str, target_state, step: Optional[int] = None, **kw):
    """One-shot restore (``--resume``)."""
    ckpt = Checkpointer(directory, **kw)
    try:
        return ckpt.restore(target_state, step)
    finally:
        ckpt.close()
