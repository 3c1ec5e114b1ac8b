"""A local world: the n ranks of a sharded pass started from the calling
process, one device each, driven call by call from rank 0.

    from idg_tpu_torch.parallel.world import local_world
    world = local_world(4, "cuda")          # rank 0 is this process, on cuda:0
    world.run(fn, *args)                    # fn(ctx, *args) on every rank
    world.begin(fn, *args); ...; world.end()   # rank 0's own part in between

Rank 0 is the caller, on cuda:0 or the CPU; ranks 1..n−1 are spawned
processes (multiprocessing's spawn, daemonic), rank r on cuda:r or the CPU.
The data plane is the default process group, NCCL between cards and gloo
on the CPU, with a ("host", "chip") 1 × n DeviceMesh over it (`ctx.mesh`).
The control plane is a gloo group: rank 0 broadcasts each call (a
module-level function, by its module, file and name, with its arguments),
every rank runs it with its RankContext, whose `state` persists from call
to call, and rank 0 gathers every rank's status, so all ranks run the same
calls in the same order. A CUDA worker loads the kernel library that rank 0
built before it started the workers.

Failures: a worker whose call raises puts its traceback on a queue and
exits, which breaks rank 0's pending gloo collective; rank 0 then raises
WorkerError with that traceback and the world is closed. A call that raises
on rank 0 terminates the workers. Every collective has a timeout: a call on
the control plane `timeout_s`, a collective of the data plane at most
COLLECTIVE_TIMEOUT_S. Rank 0 can still wait on the card behind an NCCL
collective that a dead worker never joins, and NCCL's watchdog does not end
that wait. So a thread of rank 0 watches the workers: one that has died
without rank 0 noticing within EXIT_GRACE_S ends rank 0's process, with the
workers' tracebacks on stderr, the workers killed first, and exit code 1.
A worker exits when rank 0's process is gone: it is daemonic, and a thread
of its own watches its parent.

A process holds at most one default process group, so it holds at most one
local world: `local_world` returns the live one when it matches, and the
world closes at interpreter exit, or with `close()`.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import importlib
import importlib.util
import multiprocessing
import multiprocessing.connection
import os
import queue
import sys
import threading
import time
import traceback

import torch
import torch.distributed as dist

from ..utils import trace
from ..utils.trace import span

DEFAULT_TIMEOUT_S = 600.0     # the control plane: a whole call on a rank
COLLECTIVE_TIMEOUT_S = 120.0  # the data plane: one collective
EXIT_GRACE_S = 5.0            # a dead worker that rank 0 has not noticed by then ends it
HOST = "127.0.0.1"
_WORLD = None        # this process's live LocalWorld


class WorkerError(RuntimeError):
    """A worker rank's call raised, or a worker died."""


@dataclasses.dataclass
class RankContext:
    """What a call gets on its rank."""

    rank: int
    size: int
    device: torch.device
    mesh: object          # DeviceMesh ("host", "chip"), 1 × size
    ctrl: object          # the gloo group of the control plane
    state: dict = dataclasses.field(default_factory=dict)


def _fn_ref(fn) -> tuple:
    """(module, file, qualified name) of a module-level function."""
    if "<locals>" in fn.__qualname__:
        raise ValueError(f"{fn.__qualname__} is not a module-level function; a worker "
                         "finds a call's function by its module and name")
    return fn.__module__, fn.__globals__.get("__file__"), fn.__qualname__


def _resolve_fn(ref: tuple):
    """The function of `_fn_ref`: its module as imported, else loaded from
    its file under the same name (a module loaded by path, such as the
    benchmark's recipes)."""
    name, path, qualname = ref
    module = sys.modules.get(name)
    if module is None:
        try:
            module = importlib.import_module(name)
        except ImportError:
            if path is None:
                raise
            spec = importlib.util.spec_from_file_location(name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            spec.loader.exec_module(module)
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _join(rank: int, size: int, store, device_type: str, backend: str,
          timeout_s: float) -> RankContext:
    """This rank's part of starting the world: its device, the default
    process group, the control group and the mesh, in the same order on
    every rank, then one sum over the mesh, so that NCCL builds the
    communicators of the pass's all-reduce here and not in its first pass."""
    from .distributed import hierarchical_psum, make_hier_mesh

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=min(timeout_s,
                                                                   COLLECTIVE_TIMEOUT_S)))
    ctrl = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
    mesh = make_hier_mesh(chips_per_host=size, device_type=device_type)
    hierarchical_psum(torch.zeros(1, device=device), mesh)
    if device_type == "cuda":
        torch.cuda.synchronize(device)
    return RankContext(rank, size, device, mesh, ctrl)


def _watch_parent(parent: int) -> None:
    while True:
        time.sleep(0.5)
        if os.getppid() != parent:
            os._exit(1)


def _worker(rank: int, size: int, port: int, device_type: str, backend: str,
            timeout_s: float, errors, parent: int) -> None:
    """A worker rank: join the world, then run rank 0's calls until it
    broadcasts the end (None). On any error: the traceback to `errors`,
    then exit, which breaks rank 0's collectives at once."""
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    try:
        if device_type == "cuda":
            from ..ops.cuda import build

            build.library()     # built by rank 0 before it spawned this worker: loads only
        else:
            torch.set_num_threads(1)
        store = dist.TCPStore(HOST, port, size, is_master=False,
                              timeout=datetime.timedelta(seconds=timeout_s))
        store.set(f"ready{rank}", "1")
        ctx = _join(rank, size, store, device_type, backend, timeout_s)
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=ctx.ctrl)
            if box[0] is None:
                break
            ref, args, kwargs, gather = box[0]
            out = _resolve_fn(ref)(ctx, *args, **kwargs)
            dist.gather_object(out if gather else None, None, dst=0, group=ctx.ctrl)
        dist.destroy_process_group()
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        errors.close()
        errors.join_thread()
        os._exit(1)


def _interval_medians(ctx: RankContext) -> dict:
    return trace.TRACER.interval_medians()


class LocalWorld:
    """The world of `local_world`, held by rank 0."""

    def __init__(self, context: RankContext, procs: list, errors):
        self.context = context
        self.procs = procs
        self.errors = errors
        self.closed = False
        self._in_call = False
        self._gather = False
        self._noticed = False     # rank 0's own thread has seen a failure
        if procs:
            threading.Thread(target=self._watch, daemon=True, name="idg-world-watch").start()

    @property
    def size(self) -> int:
        return self.context.size

    def begin(self, fn, *args, gather: bool = False, **kwargs) -> None:
        """Announce fn(ctx, *args, **kwargs) to the workers, which run it at
        once; rank 0 runs its own part and then calls end()."""
        if self.closed:
            raise RuntimeError("the local world is closed")
        if self._in_call:
            raise RuntimeError("a call of the local world is still open: end() it first")
        try:
            dist.broadcast_object_list([(_fn_ref(fn), args, kwargs, gather)], src=0,
                                       group=self.context.ctrl)
        except RuntimeError as exc:
            raise self._failed(exc) from exc
        self._in_call, self._gather = True, gather

    def end(self, value=None):
        """Close the call begun by begin(): every rank's status. Returns
        the ranks' values, rank 0's `value` first, if begun with
        `gather`, else None. Raises WorkerError if a worker failed."""
        outs = [None] * self.size
        try:
            dist.gather_object(value if self._gather else None, outs, dst=0,
                               group=self.context.ctrl)
        except RuntimeError as exc:
            raise self._failed(exc) from exc
        finally:
            self._in_call = False
        return outs if self._gather else None

    def run(self, fn, *args, gather: bool = False, **kwargs):
        """fn(ctx, *args, **kwargs) on every rank; rank 0's result, or with
        `gather` every rank's (small, picklable) results."""
        self.begin(fn, *args, gather=gather, **kwargs)
        try:
            out = fn(self.context, *args, **kwargs)
        except BaseException as exc:
            err = self.failure(exc)
            if err is exc:
                raise
            raise err from exc
        outs = self.end(out)
        return outs if gather else out

    def failure(self, exc: BaseException) -> BaseException:
        """What to raise for `exc`, raised by rank 0's own part of a call:
        WorkerError where a worker failed (a collective of rank 0's then
        breaks), else `exc`. The world is closed either way."""
        self._noticed = True
        if (isinstance(exc, RuntimeError) and not isinstance(exc, WorkerError)
                and not self.closed and self._worker_down()):
            return self._failed(exc)
        self._abandon()
        return exc

    def _worker_down(self, wait_s: float = 2.0) -> bool:
        deadline = time.monotonic() + wait_s
        while True:
            if not self.errors.empty() or not all(p.is_alive() for p in self.procs):
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(0.02)

    def gather_intervals(self):
        """Every rank's trace.TRACER.interval_medians(), rank 0's first, or
        None while the world is closed or inside a call."""
        if self.closed or self._in_call:
            return None
        return self.run(_interval_medians, gather=True)

    def _failed(self, exc: BaseException) -> WorkerError:
        """The error of a broken collective: a worker's traceback where one
        came (waiting a little for it), else which worker is gone."""
        self._noticed = True
        reports = []
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            try:
                reports.append(self.errors.get(timeout=0.1))
            except queue.Empty:
                if reports or all(not p.is_alive() for p in self.procs):
                    break
        dead = [(r, p.exitcode) for r, p in enumerate(self.procs, 1) if not p.is_alive()]
        self._abandon()
        if reports:
            return WorkerError("".join(f"rank {r} raised:\n{tb}" for r, tb in reports))
        return WorkerError(f"the local world broke ({exc}); workers gone (rank, exit code): "
                           f"{dead}")

    def _watch(self) -> None:
        """Rank 0's watch on its workers: once one has died, give rank 0's own
        thread EXIT_GRACE_S to notice (a broken gloo collective, `failure`)
        or to close the world; else rank 0 waits where nothing will end the
        wait, and this thread ends the process."""
        sentinels = [p.sentinel for p in self.procs]
        while not self.closed and not multiprocessing.connection.wait(sentinels, timeout=0.5):
            pass
        deadline = time.monotonic() + EXIT_GRACE_S
        while not (self.closed or self._noticed):
            if time.monotonic() > deadline:
                self._end_process()
            time.sleep(0.05)

    def _end_process(self) -> None:
        """Exit rank 0's process, code 1, after the workers' tracebacks and
        their end."""
        reports = []
        while True:
            try:
                reports.append(self.errors.get(timeout=0.2))
            except (queue.Empty, OSError, ValueError):
                break
        dead = [(r, p.exitcode) for r, p in enumerate(self.procs, 1) if not p.is_alive()]
        sys.stderr.write("".join(f"rank {r} raised:\n{tb}" for r, tb in reports)
                         + f"rank 0: workers gone (rank, exit code) {dead}, unnoticed after "
                         f"{EXIT_GRACE_S} s; ending the local world's process\n")
        sys.stderr.flush()
        sys.stdout.flush()
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=10)
        os._exit(1)

    def _abandon(self) -> None:
        """Close after a failure: terminate the workers, with no collective."""
        self._in_call = False
        self._stop(graceful=False)

    def close(self) -> None:
        """End the workers and the process groups. Idempotent."""
        self._stop(graceful=not self._in_call)

    def _stop(self, graceful: bool) -> None:
        global _WORLD
        if self.closed:
            return
        self.closed = True
        if trace.TRACER.gather == self.gather_intervals:
            trace.TRACER.gather = None
        if _WORLD is self:
            _WORLD = None
        if graceful:
            try:
                dist.broadcast_object_list([None], src=0, group=self.context.ctrl)
            except RuntimeError:
                graceful = False
        if graceful:
            dist.destroy_process_group()
        for p in self.procs:
            p.join(timeout=30 if graceful else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        while True:     # drain before the queue goes away
            try:
                self.errors.get_nowait()
            except (queue.Empty, OSError, ValueError):
                break
        # a broken CUDA world keeps its groups until the process ends:
        # tearing NCCL down with a collective pending could wait on it
        if not graceful and dist.is_initialized() and self.context.device.type != "cuda":
            dist.destroy_process_group()


def _close_live() -> None:
    if _WORLD is not None:
        _WORLD.close()


atexit.register(_close_live)


@span("idg.mesh.launch")
def local_world(size: int, device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> LocalWorld:
    """This process's local world of `size` ranks on `device` ("cuda": one
    card a rank, rank 0 on cuda:0; "cpu": gloo ranks), started at the first
    call and returned as it is by later ones. Raises when another world,
    or a process group of another origin, is up in this process."""
    global _WORLD
    device = torch.device(device)
    if _WORLD is not None:
        ctx = _WORLD.context
        if ctx.size == size and ctx.device.type == device.type:
            return _WORLD
        raise RuntimeError(f"a local world of {ctx.size} ranks on {ctx.device.type} is live")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    if device.type == "cuda":
        from ..ops.api import resolve_device
        from ..ops.cuda import build

        resolve_device(device)
        if device.index not in (None, 0):
            raise ValueError(f"rank 0 of a local world runs on cuda:0, not {device}")
        if torch.cuda.device_count() < size:
            raise ValueError(f"a local world of {size} ranks needs {size} cards, "
                             f"{torch.cuda.device_count()} visible")
        build.library()
    backend = "nccl" if device.type == "cuda" else "gloo"
    store = dist.TCPStore(HOST, 0, size, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    mp = multiprocessing.get_context("spawn")
    errors = mp.Queue()
    procs = [mp.Process(target=_worker, daemon=True, name=f"idg-rank{r}",
                        args=(r, size, store.port, device.type, backend, timeout_s, errors,
                              os.getpid()))
             for r in range(1, size)]
    for p in procs:
        p.start()
    try:
        _wait_ready(store, procs, errors, timeout_s)
        ctx = _join(0, size, store, device.type, backend, timeout_s)
    except BaseException:
        for p in procs:
            p.terminate()
            p.join(timeout=10)
        raise
    _WORLD = LocalWorld(ctx, procs, errors)
    trace.TRACER.gather = _WORLD.gather_intervals
    return _WORLD


def _wait_ready(store, procs: list, errors, timeout_s: float) -> None:
    """Wait until every worker has reached the store, raising WorkerError
    as soon as one has died on the way (an import, its card)."""
    deadline = time.monotonic() + timeout_s
    keys = [f"ready{r}" for r in range(1, len(procs) + 1)]
    while not store.check(keys):
        try:
            rank, tb = errors.get(timeout=0.05)
        except queue.Empty:
            pass
        else:
            raise WorkerError(f"rank {rank} failed to start:\n{tb}")
        dead = [r for r, p in enumerate(procs, 1) if not p.is_alive()]
        if dead:
            raise WorkerError(f"worker rank(s) {dead} exited while the world started")
        if time.monotonic() > deadline:
            raise WorkerError(f"the workers did not start within {timeout_s} s")
