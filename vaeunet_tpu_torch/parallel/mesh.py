"""Process groups, batch sharding and the rank launcher.  Port of
``vaeunet_tpu/parallel/mesh.py``.

The JAX package runs one controller over a ``jax.sharding.Mesh`` of
devices with named axes 'data' (batch sharding) and 'model' (channel
sharding of the widest convs).  Here each device is one process (a rank of
``torch.distributed``) and the mesh is a :class:`ParallelContext`: the
rank's place in a (data, model) grid, laid out as ``make_mesh`` lays out
its devices (rank = data index * model axis + model index), with one
process group per axis.

:func:`launch` is the counterpart of the single controller: it starts N
ranks with ``torch.multiprocessing.start_processes`` (spawn), joins them
through a ``FileStore`` rendezvous in a fresh temporary directory, runs
``fn(ctx, *args)`` on each and returns their results, or raises when a rank
fails or the time limit passes (the ranks are then ended).  The backend
is NCCL on CUDA when every rank has a card of its own; on the CPU, and
where ranks share a card (``share_devices=True``, e.g. two ranks on a
one-GPU machine, which NCCL refuses), it is gloo, whose CUDA support
covers the ``all_reduce`` that ``ops/collectives.py`` builds on: the
compute stays on the card and only the transport differs.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vaeunet_tpu_torch.device import host_to_device, resolve_device
from vaeunet_tpu_torch.ops.collectives import rank_rows


@dataclass
class ParallelContext:
    """One rank's view of the (data, model) mesh."""

    rank: int
    world_size: int
    n_data: int
    n_model: int
    data: Any            # process group over this rank's 'data' axis
    model: Any           # process group over this rank's 'model' axis
    device: torch.device
    backend: str

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}


def make_mesh(num_devices: Optional[int] = None, model_axis: int = 1,
              device=None) -> ParallelContext:
    """The mesh of the initialized default process group: 1-D 'data' by
    default, (data, model) when `model_axis` > 1.  Every rank calls it (it
    makes every axis group, in one order on all ranks).  Raises when more
    devices are asked for than there are ranks (``mesh.py:28-29``).  The
    rank's device is :func:`mesh_device`'s: the card unless `device` is
    ``"cpu"``."""
    world = dist.get_world_size()
    n = num_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n != world:
        raise ValueError(f"requested {n} devices of {world} ranks: each rank is one device "
                         "of the mesh")
    if n % model_axis:
        raise ValueError(f"{n} devices do not divide by model axis {model_axis}")
    rank = dist.get_rank()
    n_data = n // model_axis
    data = model = None
    for m in range(model_axis):                       # the 'data' groups, one per model index
        g = dist.new_group([d * model_axis + m for d in range(n_data)])
        if rank % model_axis == m:
            data = g
    for d in range(n_data):                           # the 'model' groups, one per data index
        g = dist.new_group([d * model_axis + m for m in range(model_axis)])
        if rank // model_axis == d:
            model = g
    backend = dist.get_backend()
    return ParallelContext(rank=rank, world_size=world, n_data=n_data, n_model=model_axis,
                           data=data, model=model, device=mesh_device(device, backend, rank),
                           backend=backend)


def mesh_device(device, backend: str, rank: int) -> torch.device:
    """The device of rank `rank` of a `backend` group: `device` as given,
    else the card of its local rank (``LOCAL_RANK``, else `rank` modulo
    the cards) under NCCL and ``resolve_device``'s default (CUDA) under
    gloo.  NCCL ranks on the CPU are refused."""
    if device is None and backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None
                              else rank % max(1, torch.cuda.device_count()))
    device = resolve_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group runs on CUDA devices, not {device}; "
                         "use gloo for CPU ranks")
    return device


def shard_batch(ctx: ParallelContext, *arrays, accum: int = 1):
    """This rank's rows of each global-batch array (numpy or torch) on its
    device, in :func:`rank_rows` order; host arrays go through pinned
    memory."""
    out = []
    for a in arrays:
        rows = rank_rows(len(a), ctx.n_data, ctx.data_rank, accum)
        if isinstance(a, torch.Tensor):
            out.append(a[torch.as_tensor(rows, device=a.device)].to(ctx.device))
        else:
            part = torch.from_numpy(np.ascontiguousarray(np.asarray(a)[rows]))
            out.append(host_to_device(part, ctx.device))
    return tuple(out) if len(out) > 1 else out[0]


@dataclass
class _RankSpec:
    fn: Callable
    args: tuple
    world_size: int
    backend: str
    device_type: str
    init_file: str
    result_dir: str
    timeout: float
    model_axis: int
    threads: int


def _rank_main(rank: int, spec: _RankSpec) -> None:
    """One rank: join the group, build the mesh, run the function, write
    its result, leave the group."""
    torch.set_num_threads(spec.threads)
    if spec.device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(spec.backend, init_method=f"file://{spec.init_file}", rank=rank,
                            world_size=spec.world_size,
                            timeout=datetime.timedelta(seconds=spec.timeout))
    try:
        ctx = make_mesh(spec.world_size, spec.model_axis, device)
        result = spec.fn(ctx, *spec.args)
        torch.save(result, Path(spec.result_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def backend_for(nprocs: int, device: str = "cuda", share_devices: bool = False) -> str:
    """The backend :func:`launch` takes for `nprocs` ranks on `device`;
    raises where CUDA is missing, or where there are fewer cards than ranks
    and `share_devices` is False."""
    if torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the ranks "
                           "on the CPU")
    cards = torch.cuda.device_count()
    if cards >= nprocs:
        return "nccl"
    if not share_devices:
        raise ValueError(f"requested {nprocs} devices, have {cards}")
    return "gloo"


def launch(fn: Callable, nprocs: int, args: Sequence = (), device: str = "cuda",
           timeout: float = 600.0, model_axis: int = 1, share_devices: bool = False,
           threads: int = 1, workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(ctx, *args)`` on `nprocs` new ranks -> their results in
    rank order.  `fn` must be importable by name (a module-level function of
    a module that the ranks may import).  `timeout` bounds the whole run
    and each collective; on a rank's failure or the time limit every rank
    is ended and the call raises."""
    backend = backend_for(nprocs, device, share_devices)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        spec = _RankSpec(fn=fn, args=tuple(args), world_size=nprocs, backend=backend,
                         device_type=torch.device(device).type,
                         init_file=str(Path(tmp) / "rendezvous"), result_dir=tmp,
                         timeout=float(timeout), model_axis=model_axis, threads=threads)
        procs = mp.start_processes(_rank_main, args=(spec,), nprocs=nprocs, join=False,
                                   start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not procs.join(timeout=min(1.0, max(0.01, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__qualname__} still running "
                                       f"after {timeout} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                        p.join(10)
        return [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu", weights_only=False)
                for r in range(nprocs)]
