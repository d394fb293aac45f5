"""Starting a pod's ranks (port of ``repro/launch/mesh.py``).

The reference runs data parallelism as one controller over a ("pod",)
mesh of devices; the port runs one ``torch.distributed`` rank per pod
member.  This module starts the ranks and makes each one's
``parallel.ctx.PodMesh`` (``axis_names == ("pod",)``, ``shape ==
{"pod": n}``, the rank, the process group and the rank's device); the
collectives that name an axis reduce over the pod that
``parallel.ctx.bind_axis`` binds to it.

**Ranks and devices.**  A rank runs on ``cuda:(local_rank %
device_count)``, or on the CPU when the caller asks for it; its local
rank is its rank on its node (``LOCAL_RANK`` under ``torchrun``, the
rank itself under ``run_ranks``).  The backend is a rule, stated in the
start-up log line, not a fallback:

* ``nccl`` when every rank has a card of its own: a node's ranks
  (``LOCAL_WORLD_SIZE`` under ``torchrun``) are no more than its cards;
* ``gloo`` when ranks share a card (NCCL refuses two ranks on one GPU) or
  run on the CPU; gloo's ``all_reduce`` takes CUDA tensors through host
  memory.

A failed initialisation raises; it never retries on another backend.

**Starting ranks.**  ``run_ranks(n, fn, args)`` makes the calling process
rank 0 and starts ranks 1..n-1 with ``torch.multiprocessing`` under the
``spawn`` start method (never ``fork``: the caller may hold a CUDA
context), so rank 0's results, a 4 GB train state among them, stay where
the caller is and only what the other ranks return (pickled) crosses
back.  ``fn`` and ``args`` must pickle.  A caller that uses the kernels
builds or loads them first (``kernels/build.load_all``), so that no two
ranks compile into the build directory at once.  Under ``torchrun``
(``WORLD_SIZE`` set) or in a process whose default group is already up,
``make_pod_mesh`` joins that group instead; a ``WORLD_SIZE`` other than
the pod's size raises.

**Failures.**  An exception that leaves a rank's ``fn`` ends the pod: the
rank tears its group down (``PodMesh.close``), so a peer that waits in a
collective with it fails too rather than resuming out of step (gloo when
the connection closes; NCCL at its timeout, ``TIMEOUT_S``, unless
``torchrun``'s agent stops the other workers first).

**Feature ranks.**  ``make_feature_rank_mesh(n_shards, device)`` makes the
rank form of ``parallel.ctx.FeatureMesh`` (shard j on rank j) on the same
start-up and backend rule: ``run_ranks`` starts the ranks, and each one's
``fn`` builds its rank mesh, which joins the group its pod member is in.
The executor's cross stages go over the group (with gloo, CUDA slabs are
staged through the host), and the overlap schedule's fused pairs on the
card through CUDA IPC slots between the partner ranks
(``kernels/peer.py``), which work between processes on one card and
across cards alike.

``make_host_mesh`` is a one-member pod on the caller's device.
``make_production_mesh`` (256/512 chips) belongs with the dry-run.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import socket
import sys
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel.ctx import FeatureMesh, PodMesh

__all__ = ["make_pod_mesh", "make_host_mesh", "make_production_mesh",
           "make_feature_rank_mesh", "pod_device", "pod_backend",
           "run_ranks"]
TIMEOUT_S = 600.0          # a collective's limit before it raises

def pod_device(local_rank: int, device: Any = None) -> torch.device:
    """The device of the rank ``local_rank`` on its node: the CPU when
    ``device`` is the CPU, else ``cuda:(local_rank % device_count)``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the plain versions on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def pod_backend(local_ranks: int, device: Any = None) -> tuple:
    """``(backend, reason)`` for ``local_ranks`` ranks on one node, on
    ``device``'s kind."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if local_ranks > cards:
        return "gloo", (f"{local_ranks} ranks share {cards} card(s); NCCL "
                        f"takes one rank a card")
    return "nccl", (f"one card a rank ({local_ranks} of {cards} on a "
                    f"node)")


def _local(rank: int, n_pod: int) -> tuple:
    """``(local rank, ranks on this node)``: ``torchrun``'s, else a
    one-node pod's."""
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", n_pod)))


def make_host_mesh(device: Any = None) -> PodMesh:
    """A one-member pod on ``device`` (default ``cuda``)."""
    return PodMesh(rank=0, size=1, device=pod_device(0, device))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 256/512-chip mesh: not ported yet."""
    raise NotImplementedError(
        "make_production_mesh comes with the dry-run (ROADMAP.md §1, item "
        "7)")


def _log(msg: str) -> None:
    print(msg, flush=True)


def make_pod_mesh(n_pod: int, device: Any = None, *,
                  rank: Optional[int] = None,
                  init_method: Optional[str] = None,
                  timeout_s: float = TIMEOUT_S) -> PodMesh:
    """This process's member of a pod of ``n_pod`` ranks.

    Joins the default group when it is up, else initialises it: from
    ``init_method`` and ``rank`` when given (``run_ranks``), else from the
    environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``).  The world must have ``n_pod``
    ranks.  One member needs no group."""
    if n_pod < 1:
        raise ValueError(f"a pod has at least one member, got {n_pod}")
    if n_pod == 1 and not dist.is_initialized() and init_method is None:
        return make_host_mesh(device)
    if dist.is_initialized():
        world = dist.get_world_size()
        if world != n_pod:
            raise ValueError(f"the process group has {world} ranks, the "
                             f"pod {n_pod}")
        rank = dist.get_rank()
        dev = pod_device(_local(rank, n_pod)[0], device)
        return PodMesh(rank=rank, size=n_pod, device=dev,
                       backend=dist.get_backend())
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            raise ValueError(
                f"a pod of {n_pod} needs its ranks: start them with "
                f"launch.mesh.run_ranks or torchrun")
        world = int(os.environ["WORLD_SIZE"])
        if world != n_pod:
            raise ValueError(f"WORLD_SIZE={world} but --pod-dp {n_pod}")
        rank = int(os.environ["RANK"])
        local_rank, local_ranks = _local(rank, n_pod)
        init_method = "env://"
    else:                              # run_ranks: one node
        local_rank, local_ranks = rank, n_pod
    backend, why = pod_backend(local_ranks, device)
    dev = pod_device(local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=n_pod, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        _log(f"pod: {n_pod} ranks, backend {backend} ({why}), rank 0 on "
             f"{dev}")
    return PodMesh(rank=rank, size=n_pod, device=dev, backend=backend,
                   owned=True)


def make_feature_rank_mesh(n_shards: int, device: Any = None, *,
                           rank: Optional[int] = None,
                           init_method: Optional[str] = None,
                           timeout_s: float = TIMEOUT_S) -> FeatureMesh:
    """This process's rank of a feature mesh of ``n_shards`` ranks, shard j
    on rank j: the group is ``make_pod_mesh``'s (joined when it is up, as
    in a ``run_ranks`` job), so is the backend rule.  The caller keeps the
    group: a pod member that ``run_ranks`` made closes it."""
    pod = make_pod_mesh(n_shards, device, rank=rank, init_method=init_method,
                        timeout_s=timeout_s)
    if pod.size < 2:
        raise ValueError(f"a feature mesh of ranks needs at least 2, got "
                         f"{n_shards}")
    backend = pod.backend or dist.get_backend()
    if pod.rank == 0:
        _, why = pod_backend(_local(pod.rank, n_shards)[1], device)
        staged = ("CUDA slabs staged through the host"
                  if backend == "gloo" and pod.device.type == "cuda"
                  else "on the rank's device" if backend == "nccl"
                  else "on the host")
        _log(f"feature mesh: {n_shards} ranks, one shard a rank, backend "
             f"{backend} ({why}); cross-stage exchanges over the group "
             f"({staged}); the overlap pairs on the card through CUDA IPC "
             f"slots between partner ranks")
    return FeatureMesh((pod.device,) * n_shards, rank=pod.rank,
                       group=pod.group, backend=backend)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank: int, n: int, init_method: str, device: Any,
           threads: Optional[int], timeout_s: float, jobs, results) -> None:
    """A spawned rank: take ``(fn, args)`` from ``jobs``, join the pod, run
    ``fn``, send back its pickled result or its traceback."""
    mesh = None
    try:
        if threads:
            torch.set_num_threads(threads)
        fn, args = pickle.loads(jobs.get())
        mesh = make_pod_mesh(n, device, rank=rank, init_method=init_method,
                             timeout_s=timeout_s)
        out = fn(mesh, *args)
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:                       # noqa: BLE001 — reported
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    finally:
        if mesh is not None:
            mesh.close()


def run_ranks(n: int, fn: Callable, args: Sequence = (), *,
              device: Any = None, local: Optional[dict] = None,
              threads: Optional[int] = None,
              timeout_s: float = TIMEOUT_S) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n`` ranks: this process is rank 0
    (with ``**local`` added to its call: objects that stay here), ranks
    1..n-1 are spawned.  Returns every rank's result, in rank order.
    ``threads`` sets each rank's torch threads (rank 0's for the call's
    length).  A rank that fails fails the call with its traceback; every
    spawned process is stopped before this returns."""
    if n < 2:
        raise ValueError(f"run_ranks needs at least 2 ranks, got {n}")
    if dist.is_initialized():
        raise RuntimeError("a process group is up already: call fn on "
                           "make_pod_mesh's member instead")
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    results, jobs = ctx.Queue(), ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_child,
                         args=(r, n, init_method, device, threads, timeout_s,
                               jobs, results), daemon=True)
             for r in range(1, n)]
    for p in procs:
        p.start()
    # the job goes by queue, not with the process object: a large one
    # would hold each start until that rank had imported its modules
    payload = pickle.dumps((fn, tuple(args)))
    for _ in procs:
        jobs.put(payload)
    saved_threads = torch.get_num_threads()
    got: Dict[int, Any] = {}
    errors: Dict[int, str] = {}

    def collect(wait_s: float) -> None:
        while len(got) + len(errors) < n - 1:
            try:
                r, ok, payload = results.get(timeout=wait_s)
            except queue.Empty:
                dead = [i + 1 for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and i + 1 not in got and i + 1 not in errors]
                for r in dead:
                    errors[r] = f"exited with code {procs[r - 1].exitcode}"
                if wait_s < 1.0 or dead:
                    return
                continue
            if ok:
                got[r] = pickle.loads(payload)
            else:
                errors[r] = payload

    mesh = None
    try:
        if threads:
            torch.set_num_threads(threads)
        try:
            mesh = make_pod_mesh(n, device, rank=0, init_method=init_method,
                                 timeout_s=timeout_s)
            out0 = fn(mesh, *args, **(local or {}))
        except BaseException as e:
            collect(0.5)
            if errors:
                raise RuntimeError("pod ranks failed:\n" + "\n".join(
                    f"rank {r}: {m}" for r, m in sorted(errors.items()))
                ) from e
            raise
        collect(5.0)
        if errors:
            raise RuntimeError("pod ranks failed:\n" + "\n".join(
                f"rank {r}: {m}" for r, m in sorted(errors.items())))
        return [out0] + [got[r] for r in range(1, n)]
    finally:
        torch.set_num_threads(saved_threads)
        if mesh is not None:
            mesh.close()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
        results.close()
        jobs.close()
