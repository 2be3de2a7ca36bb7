"""Processes of one consensus run over ``torch.distributed``.

The JAX MPI CLI runs multi-host as one SPMD program:
``jax.distributed.initialize(coordinator, num_processes, process_id)``
(``sagecal_tpu/cli_mpi.py:225-232``; the reference's ``mpirun`` ranks,
``src/MPI/main.cpp:311-346``), a mesh over every device of every process
(``:358-378``) whose consensus sums are ``psum`` over the subband axis,
and ``multihost_utils.process_allgather`` of the outputs to every process
(``:569-587``). The JAX package has no module of its own for this; here
it is :func:`init` and a handful of collectives:

- :func:`init` joins the group at ``tcp://<coordinator>``. The control
  group is gloo. The data collectives (tensors on a card) use NCCL when no
  two ranks share a card (the card UUIDs are gathered over gloo first),
  and otherwise gloo on host copies: gloo takes no CUDA tensors in
  ``all_gather``, and NCCL refuses two ranks on one device. A failed NCCL
  init raises; it never gives way to gloo. Host tensors always go
  through the control group.
- :func:`all_reduce_sum`, :func:`all_gather` (along the leading axis, in
  rank order), :func:`gather_to_root`, :func:`broadcast_from`,
  :func:`all_gather_object` and :func:`barrier`; with no group (one
  process) each is the identity.
- :func:`shutdown`, which a caller runs in a ``finally``.

A rank's device is card ``rank % device_count`` (``device.resolve``), or
the CPU under ``--platform cpu``, where every rank computes at one
thread: gloo's ranks share the host's cores.

:func:`run_ranks` starts P ranks of the MPI CLI on this host, each at
:data:`RANK_THREADS` torch threads, on a free port (the tests' and
``chip_smoke.py``'s launcher; :func:`spawn` beneath it: a timeout, and
the first rank that fails ends the rest). A node's ranks are as well
started by hand, one ``python -m sagecal_tpu_torch.cli_mpi ...
--coordinator host:port --num-processes P --process-id r`` each.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import socket
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as tdist


#: torch threads of each rank that :func:`spawn` starts: the ranks of one
#: host share its cores
RANK_THREADS = 1
#: seconds :func:`spawn` waits, after the first rank fails, for the others'
#: reports (theirs often follow from it: a peer that left)
FAIL_GRACE_S = 5.0
#: seconds a collective waits for its peers
COLLECTIVE_TIMEOUT_S = 1800.0


class Group(NamedTuple):
    """A joined process group: ``world`` ranks, this one ``rank`` on
    ``device``; ``backend`` of the data collectives ("nccl" or "gloo"),
    ``reason`` why, and ``data`` the NCCL group (None on gloo)."""

    world: int
    rank: int
    device: torch.device
    backend: str
    reason: str
    data: object = None


def free_port() -> int:
    """A TCP port on localhost that is free now (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card_id(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return str(uuid)
    return f"{socket.gethostname()}:{device.index}"


def init(coordinator: str, world: int, rank: int,
         device: torch.device) -> Group:
    """Join the group of ``world`` processes at ``tcp://<coordinator>``
    (``host:port``; rank 0 listens there) as ``rank`` on ``device``, and
    choose the data collectives' backend (module docstring)."""
    world, rank = int(world), int(rank)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"process {rank} of {world}: need 0 <= rank < "
                         "world")
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if device.type != "cuda":
        torch.set_num_threads(1)
        return Group(world, rank, device, "gloo", "the CPU")
    torch.cuda.set_device(device)
    ids = [None] * world
    tdist.all_gather_object(ids, _card_id(device))
    if len(set(ids)) < world:
        return Group(world, rank, device, "gloo",
                     f"{world} ranks on {len(set(ids))} card(s): NCCL "
                     "refuses two ranks on one device, so gloo on host "
                     "copies")
    data = tdist.new_group(backend="nccl")
    # bring the communicator up now: a failure raises here
    probe = torch.ones(1, device=device)
    tdist.all_reduce(probe, group=data)
    if int(probe.item()) != world:
        raise RuntimeError(f"NCCL all-reduce over {world} ranks gave "
                           f"{probe.item()}")
    return Group(world, rank, device, "nccl",
                 f"{world} rank(s) on {world} distinct card(s)", data)


def shutdown(group: Group | None) -> None:
    """Leave the group (nothing without one)."""
    if group is not None and tdist.is_initialized():
        tdist.destroy_process_group()


def _route(t: torch.Tensor, group: Group):
    """(the tensor to hand the collective, its process group): a card
    tensor on NCCL as it is, anything else as a contiguous host copy on
    the control group; complex tensors as their real pairs."""
    x = torch.view_as_real(t) if t.is_complex() else t
    if x.device.type == "cuda" and group.backend == "nccl":
        return x.contiguous().clone(), group.data
    return x.detach().to("cpu", copy=True).contiguous(), None


def _back(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A collective's result ``x`` on ``like``'s device and type."""
    x = x.to(like.device)
    return torch.view_as_complex(x.contiguous()) if like.is_complex() else x


def all_reduce_sum(t: torch.Tensor, group: Group | None) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on ``t``'s device."""
    if group is None:
        return t
    x, pg = _route(t, group)
    tdist.all_reduce(x, group=pg)
    return _back(x, t)


def all_gather(t: torch.Tensor, group: Group | None) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along the
    leading axis in rank order, on ``t``'s device."""
    if group is None:
        return t
    x, pg = _route(t, group)
    parts = [torch.empty_like(x) for _ in range(group.world)]
    tdist.all_gather(parts, x, group=pg)
    return _back(torch.cat(parts), t)


def gather_to_root(t: torch.Tensor, group: Group | None):
    """Every rank's host tensor ``t`` concatenated along the leading axis
    in rank order on rank 0 (None on the others), over the control
    group."""
    if group is None:
        return t
    x = t.detach().to("cpu").contiguous()
    parts = [torch.empty_like(x) for _ in range(group.world)] \
        if group.rank == 0 else None
    tdist.gather(x, parts, dst=0)
    return torch.cat(parts) if group.rank == 0 else None


def broadcast_from(t: torch.Tensor, group: Group | None,
                   src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (the same shape on each), on
    ``t``'s device."""
    if group is None:
        return t
    x, pg = _route(t, group)
    tdist.broadcast(x, src, group=pg)
    return _back(x, t)


def all_gather_object(obj, group: Group | None) -> list:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` without a
    group)."""
    if group is None:
        return [obj]
    out = [None] * group.world
    tdist.all_gather_object(out, obj)
    return out


def barrier(group: Group | None) -> None:
    if group is not None:
        tdist.barrier()


def _child(fn, args, rank, results):
    """One rank of :func:`spawn`: ``fn(rank, *args)`` at
    :data:`RANK_THREADS` threads; (rank, True, its result) or (rank,
    False, the traceback) onto ``results``."""
    try:
        torch.set_num_threads(RANK_THREADS)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, args=(), timeout: float = 900.0) -> list:
    """``fn(rank, *args)`` in ``world`` spawned processes on this host
    (``fn`` importable by name); returns their results in rank order. The
    first rank that fails, or the ``timeout`` in seconds, ends every rank,
    and the error is raised with every failure reported within
    :data:`FAIL_GRACE_S` of the first; the ranks are daemons, so none
    outlives this process."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, args, r, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    failed: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(failed) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                r, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in got and r not in failed \
                            and p.exitcode not in (None, 0):
                        failed[r] = f"exited with code {p.exitcode}"
                continue
            if ok:
                got[r] = payload
                continue
            failed[r] = payload
            deadline = min(deadline, time.monotonic() + FAIL_GRACE_S)
        if failed:
            raise RuntimeError("\n".join(f"rank {r} failed:\n{failed[r]}"
                                         for r in sorted(failed)))
        if len(got) < world:
            raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))}"
                               f" did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.is_alive() and len(got) < world:
                p.terminate()
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def _cli_rank(rank, argv, world, port):
    from sagecal_tpu_torch import cli_mpi
    lines: list = []
    hist = cli_mpi.run(list(argv) + [
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
        "--process-id", str(rank)], log=lines.append)
    return hist, lines


def run_ranks(argv, world: int, timeout: float = 900.0) -> list:
    """Run the MPI CLI (``cli_mpi.run``) as ``world`` ranks on this host
    (:func:`spawn`), each given ``argv`` and ``--coordinator
    127.0.0.1:<a free port> --num-processes world --process-id r``.
    Returns per rank, in rank order, (records, log lines)."""
    return spawn(_cli_rank, world, (list(argv), world, free_port()),
                 timeout)
