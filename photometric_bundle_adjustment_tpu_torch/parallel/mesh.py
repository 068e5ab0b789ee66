"""Process groups and collectives of the distributed solvers.

Port of ``photometric_bundle_adjustment_tpu/parallel/mesh.py``.  The JAX
package shards over a device mesh inside one program (``shard_map``); the
port runs one process per rank over ``torch.distributed``, each rank
holding its shard on its device, and the solvers call their collectives
through a ``Comm``.

**Backend rule.**  NCCL where every rank owns its own GPU (the ranks fit
on the host's cards, one each); Gloo where ranks share a GPU or run on the
CPU.  A ``backend=`` argument overrides the rule.  NCCL refuses two ranks
on one device, so on a one-card host D > 1 ranks share ``cuda:0`` under
Gloo and NCCL runs at D = 1.  A job over several hosts
(``initialize_multihost``) applies the rule per host, to its local ranks
(``host_rule``).

**Collectives.**  The four the solvers use, each a method of ``Comm``:

  * ``psum``: a sum over ranks (one ``all_reduce`` of the tensors
    flattened into one buffer);
  * ``all_gather``: tiled along dim 0;
  * ``psum_scatter``: the sum over ranks, each rank keeping its own tile
    of dim 0;
  * ``ppermute``: a ring shift, rank r receiving rank r - shift's tensor.

Under NCCL they are ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``isend``/``irecv``.  Gloo documents only
``all_reduce`` and ``broadcast`` for CUDA tensors, so under Gloo
``all_gather`` is an ``all_reduce`` of a zero-filled (D, ...) buffer that
holds the rank's tile in its own row (adding zeros is exact: the gathered
bits are the tiles' bits), ``psum_scatter`` an ``all_reduce`` of the whole
tensor followed by the rank's own tile, and ``ppermute`` a send and a
receive staged through host memory.  The compute stays on the device
either way.  Each ``Comm`` counts its collectives and the bytes it hands
them (``calls``, ``bytes``).

Every collective is issued at any world size, one rank included (a
one-rank NCCL group runs NCCL's kernels); only ``ppermute`` returns a copy
there, a rank sending to itself.  Every group carries a timeout (``datetime.timedelta``): a collective that
waits longer fails the rank, and ``spawn`` fails the call with that
rank's traceback.
"""

from __future__ import annotations

import collections
import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from photometric_bundle_adjustment_tpu_torch import device as devices

# a collective's timeout and a spawned group's wall limit (seconds), read
# by ``spawn`` at each call
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)
DEFAULT_WALL_LIMIT = 3600.0


def backend_for(device, n_ranks: int) -> tuple[str, str]:
    """``(backend, reason)`` by the backend rule."""
    device = torch.device(device)
    if device.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl", "every rank owns its own GPU"
    if device.type == "cuda":
        return "gloo", f"{n_ranks} ranks share {torch.cuda.device_count()} GPU(s)"
    return "gloo", "ranks run on the CPU"


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: ``cuda:rank`` under NCCL, the named device
    (shared) otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank)
    if device.type == "cuda":
        return torch.device("cuda", device.index or 0)
    return device


class Comm:
    """One rank's view of a process group: its rank, the world size, the
    backend, its device, and the collectives of the module docstring."""

    def __init__(self, rank: int, world: int, backend: str,
                 device: torch.device, group=None):
        self.rank, self.world = rank, world
        self.backend, self.device, self.group = backend, device, group
        self.calls = collections.Counter()
        self.bytes = collections.Counter()

    def describe(self) -> str:
        return (f"{self.world} rank(s), backend {self.backend}, rank "
                f"{self.rank} on {self.device}")

    def _count(self, kind: str, nbytes: int, tag: str | None):
        key = f"{tag}.{kind}" if tag else kind
        self.calls[key] += 1
        self.bytes[key] += int(nbytes)

    def reset_counts(self):
        self.calls.clear()
        self.bytes.clear()

    def psum(self, *xs: torch.Tensor, tag: str | None = None):
        """The sum over ranks of each tensor (one collective for all of
        them; they share a dtype).  Returns a tensor for one argument, a
        tuple for several.  ``tag`` (here and in the other collectives)
        prefixes the counters' key: ``"<tag>.psum"``."""
        flat = torch.cat([x.reshape(-1) for x in xs])
        self._count("psum", flat.numel() * flat.element_size(), tag)
        dist.all_reduce(flat, group=self.group)
        out, i = [], 0
        for x in xs:
            out.append(flat[i:i + x.numel()].reshape(x.shape))
            i += x.numel()
        return out[0] if len(xs) == 1 else tuple(out)

    def all_gather(self, x: torch.Tensor, tag: str | None = None):
        """Every rank's ``x`` concatenated along dim 0, in rank order."""
        if x.dtype == torch.bool:
            return self.all_gather(x.to(torch.uint8), tag).bool()
        self._count("all_gather", x.numel() * x.element_size(), tag)
        src = x.contiguous()
        if self.backend == "nccl":
            out = src.new_empty((self.world * src.shape[0],) + src.shape[1:])
            dist.all_gather_into_tensor(out, src, group=self.group)
            return out
        buf = src.new_zeros((self.world,) + src.shape)
        buf[self.rank] = src
        dist.all_reduce(buf, group=self.group)
        return buf.reshape((self.world * src.shape[0],) + src.shape[1:])

    def psum_scatter(self, x: torch.Tensor, tag: str | None = None):
        """The sum over ranks of ``x``, of which this rank keeps tile
        ``rank`` of dim 0 (``x.shape[0]`` a multiple of the world size)."""
        n = x.shape[0] // self.world
        if n * self.world != x.shape[0]:
            raise ValueError(f"dim 0 of {tuple(x.shape)} is not a multiple "
                             f"of the world size {self.world}")
        self._count("psum_scatter", x.numel() * x.element_size(), tag)
        src = x.contiguous()
        if self.backend == "nccl":
            out = src.new_empty((n,) + src.shape[1:])
            dist.reduce_scatter_tensor(out, src, group=self.group)
            return out
        buf = src.clone()
        dist.all_reduce(buf, group=self.group)
        return buf[self.rank * n:(self.rank + 1) * n].clone()

    def ppermute(self, x: torch.Tensor, shift: int = 1,
                 tag: str | None = None) -> torch.Tensor:
        """Ring shift: this rank sends ``x`` to rank + shift and returns
        what rank - shift sent."""
        if x.dtype == torch.bool:
            return self.ppermute(x.to(torch.uint8), shift, tag).bool()
        self._count("ppermute", x.numel() * x.element_size(), tag)
        if self.world == 1:
            return x.clone()
        dst = (self.rank + shift) % self.world
        src = (self.rank - shift) % self.world
        send = x.contiguous()
        if self.backend != "nccl":
            send = send.cpu()
        recv = torch.empty_like(send)
        reqs = [dist.isend(send, dst, group=self.group),
                dist.irecv(recv, src, group=self.group)]
        for r in reqs:
            r.wait()
        return recv.to(x.device)


def host_rule(device, local_rank: int, local_world: int,
              backend: str | None = None) -> tuple[str, torch.device, str]:
    """``(backend, device, reason)`` of the process that is local rank
    ``local_rank`` of ``local_world`` processes on its host, by the backend
    rule against this host's ``torch.cuda.device_count()``: NCCL on
    ``cuda:local_rank`` where the host's processes each own a card, Gloo on
    the shared card (``device``'s index, 0 by default) where they outnumber
    its cards, Gloo on the CPU.  The global rank plays no part: rank 8 of
    a job on two 8-card hosts is local rank 0 of the second.  ``backend``
    overrides the rule's backend."""
    reason = "the caller's choice"
    if backend is None:
        backend, reason = backend_for(device, local_world)
    return backend, rank_device(device, local_rank, backend), reason


def init(rank: int, world: int, *, backend: str | None = None,
         init_method: str = "env://", device="cuda",
         timeout: datetime.timedelta = DEFAULT_TIMEOUT,
         rank_dev: torch.device | None = None) -> Comm:
    """Join the process group as ``rank`` of ``world`` and return its
    ``Comm``.  ``device`` names the device type (and, shared, its index);
    ``backend`` overrides the backend rule.  ``rank_dev`` is the rank's own
    device, given with its ``backend`` (``initialize_multihost``); by
    default the rule picks both from ``rank``, every rank being local
    (``spawn``)."""
    device = devices.resolve(device)
    if rank_dev is None:
        backend, rank_dev, _ = host_rule(device, rank, world, backend)
    if rank_dev.type == "cuda":
        torch.cuda.set_device(rank_dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    return Comm(rank, world, backend, rank_dev, dist.group.WORLD)


def initialize_multihost(*, backend: str | None = None, device="cuda",
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                         log=print) -> Comm:
    """Join a run started by ``torchrun`` (its ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` in the environment, the store
    at ``env://``): the counterpart of the JAX package's
    ``initialize_multihost``.  The backend and the process's device follow
    ``host_rule`` from its local rank and the host's process count (without
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, one host: the global ones)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = devices.resolve(device)
    backend, dev, reason = host_rule(device, local_rank, local_world, backend)
    comm = init(rank, world, backend=backend, init_method="env://",
                device=device, timeout=timeout, rank_dev=dev)
    if rank == 0:
        log(f"mesh: {comm.describe()} ({reason})")
    return comm


def make_host_chip_mesh(hosts: int, chips_per_host: int,
                        device_type: str = "cuda"):
    """2-D (host, data) device mesh over an initialised group: landmarks
    shard over the chips of a host, keyframe blocks over hosts.  Returns
    a ``torch.distributed.device_mesh.DeviceMesh`` with dims ``("host",
    "data")``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (hosts, chips_per_host),
                            mesh_dim_names=("host", "data"))


def _rank_main(rank, fn, world, init_method, backend, device, timeout,
               result_path, threads, args_path):
    if threads:
        torch.set_num_threads(threads)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    comm = init(rank, world, backend=backend, init_method=init_method,
                device=device, timeout=timeout)
    try:
        out = fn(comm, *args)
        if rank == 0:
            with open(result_path + ".part", "wb") as f:
                pickle.dump(out, f)
            os.replace(result_path + ".part", result_path)
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, *args, device="cuda", backend: str | None = None,
          timeout: datetime.timedelta | None = None,
          wall_limit: float | None = None, threads: int | None = None,
          log=print):
    """Run ``fn(comm, *args)`` on ``n_ranks`` new processes
    (``torch.multiprocessing``, start method spawn) and return rank 0's
    result.

    The ranks meet at a ``file://`` store in a fresh temporary directory
    (no TCP port, so concurrent groups cannot collide).  ``fn`` must be
    importable by name (a module-level function of the port) and its
    result picklable.  ``args`` are pickled once into that directory and
    each rank loads them there: handed to the processes at their start,
    they would make each process's start wait for the one before it to
    import torch (the parent's write to a process blocks until it reads).
    A failing rank fails the call with that rank's traceback (the others
    are terminated); a group still running after
    ``wall_limit`` seconds is killed and ``TimeoutError`` raised.
    ``timeout`` (each collective's) and ``wall_limit`` default to
    ``DEFAULT_TIMEOUT`` and ``DEFAULT_WALL_LIMIT``.
    ``threads`` sets each rank's intra-op threads (default: the host's
    cores shared out).  The backend rule is printed through ``log``."""
    import torch.multiprocessing as mp

    device = devices.resolve(device)
    timeout = DEFAULT_TIMEOUT if timeout is None else timeout
    wall_limit = DEFAULT_WALL_LIMIT if wall_limit is None else wall_limit
    reason = "the caller's choice"
    if backend is None:
        backend, reason = backend_for(device, n_ranks)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n_ranks)
    log(f"mesh: {n_ranks} rank(s) on {device.type}, backend {backend} "
        f"({reason})")
    with tempfile.TemporaryDirectory(prefix="pba_mesh_") as tmp:
        result_path = os.path.join(tmp, "result.pkl")
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, n_ranks, "file://" + os.path.join(tmp, "store"),
                  backend, str(device), timeout, result_path, threads,
                  args_path),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + wall_limit
        try:
            while not ctx.join(timeout=max(0.1, min(
                    5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks of "
                                       f"{getattr(fn, '__name__', fn)} still "
                                       f"ran after {wall_limit} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        with open(result_path, "rb") as f:
            return pickle.load(f)


def run_calls(comm: Comm, calls) -> list:
    """Rank function: run each ``(fn, args, kwargs)`` of ``calls`` in
    order, ``fn(comm, *args, **kwargs)``, on one group; returns the list of
    results."""
    return [fn(comm, *args, **kwargs) for fn, args, kwargs in calls]


def selftest(comm: Comm) -> dict:
    """Each collective of ``comm`` against its definition on rank-made
    f32, int32 and bool tensors on the rank's device, and at an even
    world size a sum over the "data" dim of ``make_host_chip_mesh(2,
    D / 2)``; raises on a mismatch.  Returns the rank-0 view: the checks
    made and the counts."""
    D, r, dev = comm.world, comm.rank, comm.device
    checks = []

    def want(got, ref, name):
        if not torch.equal(got.cpu(), ref.cpu()):
            raise AssertionError(f"rank {r}: {name} {got} != {ref}")
        checks.append(name)

    x = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + 10 * r
    total = sum(torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * k
                for k in range(D))
    a, b = comm.psum(x, x[0, :2])
    want(a, total, "psum")
    want(b, total[0, :2], "psum (second tensor)")
    g = comm.all_gather(x)
    want(g, torch.cat([torch.arange(6, dtype=torch.float32).reshape(2, 3)
                       + 10 * k for k in range(D)]), "all_gather f32")
    i = torch.full((3,), r, dtype=torch.int32, device=dev)
    want(comm.all_gather(i), torch.arange(D, dtype=torch.int32)
         .repeat_interleave(3), "all_gather int32")
    m = torch.tensor([r % 2 == 0, True], device=dev)
    want(comm.all_gather(m), torch.tensor([v for k in range(D)
                                           for v in (k % 2 == 0, True)]),
         "all_gather bool")
    s = torch.arange(2 * D, dtype=torch.float32, device=dev) * (r + 1)
    full = torch.arange(2 * D, dtype=torch.float32) * (D * (D + 1) // 2)
    want(comm.psum_scatter(s), full[2 * r:2 * r + 2], "psum_scatter")
    p = torch.full((2, 2), r, dtype=torch.int32, device=dev)
    want(comm.ppermute(p), torch.full((2, 2), (r - 1) % D, dtype=torch.int32),
         "ppermute int32")
    want(comm.ppermute(m), torch.tensor([((r - 1) % D) % 2 == 0, True]),
         "ppermute bool")
    if D % 2 == 0:
        # the 2-D (host, data) mesh: a sum over the "data" dim's group
        mesh2 = make_host_chip_mesh(2, D // 2, dev.type)
        ones = torch.ones(1, device=dev)
        dist.all_reduce(ones, group=mesh2.get_group("data"))
        want(ones, torch.full((1,), float(D // 2)), "host x data mesh")
    return {"checks": checks, "calls": dict(comm.calls),
            "backend": comm.backend, "world": D, "device": str(dev)}
