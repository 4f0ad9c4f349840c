"""Starting and joining a group of ranks.

The port of ``pygcn_tpu/parallel/launcher.py``. JAX's multi-host runs start
one process per host and ``jax.distributed.initialize`` joins them; here one
process per rank joins a ``torch.distributed`` process group:

- :func:`initialize_multihost` joins the group that ``torchrun`` (or any
  launcher) describes in ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
  ``MASTER_PORT``, or the one its arguments describe; with neither it does
  nothing and reports rank 0 of 1. The backend is NCCL for ``cuda`` (one
  card per rank: ``LOCAL_RANK``, else the rank modulo the visible cards)
  and gloo for ``cpu``.
- :class:`LocalRanks` starts N ranks on this host itself: processes of
  ``torch.multiprocessing``'s ``spawn`` context that meet through a
  ``file://`` rendezvous in a temporary directory (no port to pick), then
  run the jobs they are handed, one at a time and all ranks together, until
  closed. :func:`start_ranks` runs one job on N of them: the CLIs'
  ``--shards``/``--data_parallel`` start their ranks with it, and the tests
  reuse one group for many cases.
- :func:`rank0_value` and :func:`any_rank` make a decision that a rank
  takes alone (a file's existence, a preemption signal) the ranks' common
  one, so that they keep calling their collectives in one order.

Typical use::

    info = initialize_multihost(device="cuda")     # no-op without torchrun
    mesh = make_mesh([info.process_count], ["graph"])
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class HostInfo:
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int
    distributed: bool


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None, device: str = "cpu",
                         timeout_s: Optional[float] = None) -> HostInfo:
    """Join a process group; a no-op when one is initialised already, or
    when neither the arguments nor the environment describe one.

    ``init_method`` (``"env://"``, ``"file://..."``, ``"tcp://..."``) with
    ``world_size`` and ``rank``; without ``init_method`` the ``torchrun``
    variables, when ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` are all
    set. ``timeout_s`` bounds each collective (the backend's default when
    ``None``)."""
    device_type = torch.device(device).type
    env = os.environ
    if not dist.is_initialized():
        if init_method is None and all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            init_method = "env://"
        if init_method is not None:
            world_size = int(env["WORLD_SIZE"] if world_size is None else world_size)
            rank = int(env["RANK"] if rank is None else rank)
            if device_type == "cuda":
                local = int(env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
                torch.cuda.set_device(local)
            kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
            dist.init_process_group(_backend(device_type), init_method=init_method,
                                    world_size=world_size, rank=rank, **kw)
    distributed = dist.is_initialized()
    return HostInfo(
        process_index=dist.get_rank() if distributed else 0,
        process_count=dist.get_world_size() if distributed else 1,
        local_devices=torch.cuda.device_count() if device_type == "cuda" else 1,
        global_devices=dist.get_world_size() if distributed else 1,
        distributed=distributed,
    )


def _rank_loop(rank: int, world_size: int, init_method: str, device: str,
               timeout_s: Optional[float],
               jobs, results) -> None:
    """A rank of :class:`LocalRanks`: join the group, then run each job
    ``(fn, args)`` and report ``(rank, ok, result or traceback)`` until
    handed ``None``."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        initialize_multihost(init_method, world_size, rank, device, timeout_s)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while (job := jobs.get()) is not None:
            fn, args = job
            try:
                results.put((rank, True, fn(*args)))
            except (Exception, SystemExit):  # an app's SystemExit too: report it
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class LocalRanks:
    """``world_size`` ranks on this host, started once, that run jobs in turn.

    ``run(fn, *args)`` hands every rank the same job; each rank calls
    ``fn(*args)`` inside the group (so ``fn`` and its arguments must pickle:
    a module-level function) and the call returns the ranks' results in
    rank order. A rank that raises, or a job that outlasts ``timeout_s``
    (``None``: no limit; a collective that some rank never reached hangs the
    rest), closes the group and raises ``RuntimeError`` or ``TimeoutError``
    with the rank's traceback. ``timeout_s`` also bounds each collective
    inside the ranks. Use as a context manager, or call :meth:`close`."""

    def __init__(self, world_size: int, device: str = "cpu",
                 timeout_s: Optional[float] = 300.0):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="pygcn-ranks-")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._jobs = [ctx.SimpleQueue() for _ in range(world_size)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_loop, daemon=True,
                        args=(r, world_size, init, device, timeout_s, self._jobs[r],
                              self._results))
            for r in range(world_size)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, timeout_s: Optional[float] = None) -> list:
        if self._procs is None:
            raise RuntimeError("LocalRanks is closed")
        for q in self._jobs:
            q.put((fn, args))
        limit = self.timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + (math.inf if limit is None else limit)
        out, errors, done = [None] * self.world_size, {}, set()
        for _ in range(self.world_size):
            try:
                wait = deadline - time.monotonic()
                rank, ok, value = self._results.get(
                    timeout=None if math.isinf(wait) else max(wait, 0.1))
            except queue.Empty:
                self.close(wait_s=0.0)
                missing = sorted(set(range(self.world_size)) - done)
                raise TimeoutError(
                    f"{getattr(fn, '__name__', fn)} on {self.world_size} ranks: ranks {missing} "
                    f"gave no result in time" + (f"; failed: {errors}" if errors else "")) from None
            done.add(rank)
            if ok:
                out[rank] = value
            else:
                errors[rank] = value
                # the others may wait on the failed rank in a collective
                deadline = min(deadline, time.monotonic() + 10.0)
        if errors:
            self.close()
            rank = min(errors)
            raise RuntimeError(f"rank {rank} of {self.world_size} failed:\n{errors[rank]}")
        return out

    def close(self, wait_s: float = 10.0) -> None:
        """Stop the ranks, terminating any still running after ``wait_s``
        (a rank stuck in a collective), and remove the rendezvous
        directory."""
        if self._procs is None:
            return
        for q in self._jobs:
            q.put(None)
        deadline = time.monotonic() + wait_s
        for p in self._procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = None
        self._results.close()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "LocalRanks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_ranks(n_ranks: int, device, fn, *args):
    """Run ``fn(*args)`` on ``n_ranks`` new local ranks (one card each on
    ``cuda``, refused before anything starts beyond the visible cards) and
    return rank 0's result."""
    from pygcn_tpu_torch.parallel.mesh import require_devices

    device = torch.device(device)
    if device.type == "cuda":
        require_devices(n_ranks, torch.cuda.device_count())
    with LocalRanks(n_ranks, device=device.type, timeout_s=None) as ranks:
        return ranks.run(fn, *args)[0]


def shard_mesh(shards: int, device_name: str, argv, rank_main, axis: str = "data"):
    """A CLI's ``--shards``: ``(mesh, None)``, a 1-D mesh of ``shards``
    ranks over ``axis``, when this process is a rank of a group (or
    ``shards`` is 1: one rank, this process); else ``(None, result)``, rank
    0's result of ``rank_main(argv)`` on ``shards`` ranks started here
    (``argv`` ``None``: this process's arguments). Refused before anything
    starts: more ranks than visible cards on ``cuda``."""
    import sys

    from pygcn_tpu_torch.parallel.mesh import make_mesh, require_devices
    from pygcn_tpu_torch.utils.device import resolve_device

    if torch.device(device_name).type == "cuda":
        require_devices(shards, torch.cuda.device_count())
    if not initialize_multihost(device=device_name).distributed and shards > 1:
        return None, start_ranks(shards, device_name, rank_main,
                                 sys.argv[1:] if argv is None else list(argv))
    return make_mesh([shards], [axis], device=resolve_device(device_name)), None


def plain_values(result):
    """A CLI's result as a rank hands it back: a dict keeps its plain values
    (numbers, strings, ``None`` and lists or tuples of them); the models and
    tensors stay in the rank."""
    plain = (bool, int, float, str, list, tuple, type(None))
    if isinstance(result, dict):
        return {k: v for k, v in result.items() if isinstance(v, plain)}
    return result


def rank0_value(value, mesh):
    """Rank 0's ``value`` (any picklable object) on every rank of the mesh
    (``value`` itself without a mesh or a process group)."""
    if mesh is None or not dist.is_initialized():
        return value
    box = [value]
    group = mesh.group_all()
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0) if group else 0,
                               group=group)
    return box[0]


def any_rank(flag: bool, mesh) -> bool:
    """True on every rank of the mesh when ``flag`` is true on any
    (``flag`` itself without a mesh or a process group)."""
    if mesh is None or not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([float(flag)], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group_all())
    return bool(t.item())
