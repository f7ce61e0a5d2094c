"""The device mesh for scale-out
(counterpart of ``gaussian_processes_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a 2-D ("cells", "data") mesh:

* "cells", the data-parallel axis: independent cells of one recording (one
  stimulus set) fitted side by side;
* "data", the tensor/sequence-parallel analog: the rows of the stimuli and
  of the (nt, ntilde) Gram, i.e. the training points of one cell, with the
  E-step's and the moments' sums over them completed across the axis.

Here the mesh is a ``torch.distributed`` ``DeviceMesh`` over the default
process group: NCCL with one card per rank, or gloo with CPU processes.
GSPMD places arrays and inserts the collectives; in the port every rank
receives the whole inputs, keeps its share (``population_shardings``) and
the code completes each sum over rows with an explicit collective
(``parallel/collectives``).  Rows are split as ``torch.tensor_split``
splits them, so nt need not divide by the axis: GSPMD pads the rows, the
port pads only inside its gathers.

``run_world`` starts a world of processes on one host (the tests' gloo
worlds and ``entry.dryrun_multichip``).
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("cells", "data")
# the device each backend's collectives take, and the other way round
_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def make_mesh(n_cells_axis: Optional[int] = None,
              n_data_axis: Optional[int] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ("cells", "data") mesh over the initialized default process group.

    Defaults as the JAX package's: every rank on "cells"; one axis given,
    the other is the world size over it.  ``n_cells_axis * n_data_axis``
    must equal the world size (ValueError).  ``device_type`` defaults to
    the backend's device ("cuda" for NCCL, "cpu" for gloo), and must be
    it: nothing falls back from one to the other.  On "cuda" each rank
    takes the card ``cuda:(local_rank % device_count)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n_cells_axis is None and n_data_axis is None:
        n_cells_axis, n_data_axis = n, 1
    elif n_cells_axis is None:
        n_cells_axis = n // n_data_axis
    elif n_data_axis is None:
        n_data_axis = n // n_cells_axis
    if n_cells_axis * n_data_axis != n:
        raise ValueError(f"mesh {n_cells_axis}x{n_data_axis} != {n} devices")
    backend = str(dist.get_backend())
    want = _BACKEND_DEVICE.get(backend)
    device_type = device_type or want
    if device_type != want:
        raise ValueError(f"a {backend} process group runs its collectives "
                         f"on {want!r} tensors, not {device_type!r}")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(n_cells_axis, n_data_axis),
                      mesh_dim_names=AXES)


def check_device(mesh: DeviceMesh, t: torch.Tensor, what: str = "input"):
    """Raise unless ``t`` lies on the mesh's device type: a CUDA tensor on
    a gloo mesh, or a CPU tensor on an NCCL mesh, is never copied across."""
    if t.device.type != mesh.device_type:
        raise ValueError(f"{what} is a {t.device.type} tensor, the mesh's "
                         f"collectives run on {mesh.device_type!r}: move it "
                         f"or make the mesh on its device")


def row_range(n: int, parts: int, index: int) -> slice:
    """Rows [lo, hi) of part ``index`` of n rows split into ``parts`` as
    ``torch.tensor_split`` splits them (the first n % parts parts take one
    row more)."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return slice(lo, lo + base + (index < extra))


def population_shardings(mesh: DeviceMesh, ncells: int,
                         nt: int) -> Tuple[slice, slice]:
    """What this rank holds of a population fit: ``(cells, rows)``, its
    slice of the cells on "cells" and of the training points on "data".
    ncells must divide by the "cells" axis (ValueError), as the JAX
    package's P("cells") sharding requires."""
    n_cells_axis = mesh.size(0)
    if ncells % n_cells_axis:
        raise ValueError(f"{ncells} cells do not divide over the mesh's "
                         f"{n_cells_axis} 'cells' coordinates")
    per = ncells // n_cells_axis
    c = mesh.get_local_rank("cells")
    return (slice(c * per, (c + 1) * per),
            row_range(nt, mesh.size(1), mesh.get_local_rank("data")))


# ---------------------------------------------------------------------------
# A world of processes on one host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world_size: int, backend: str, init_file: str,
               fn: Callable, args: tuple, results) -> None:
    """One rank of ``run_world``: join the group, run ``fn(*args)``, send
    back its pickled result or the traceback."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method="file://" + init_file,
                                rank=rank, world_size=world_size)
        out = fn(*args)
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable, world_size: int, *args: Any,
              backend: str = "gloo", timeout: float = 600.0) -> List[Any]:
    """``fn(*args)`` in each rank of a new world of ``world_size``
    processes on this host (``spawn``; rendezvous through a file in a
    temporary directory), gloo with one CPU thread per rank or NCCL with
    rank i on card i.  Returns every rank's result, by rank.  ``fn`` must
    be a module-level function (the ranks import it) and its result must
    pickle.  A rank that fails ends the world: its traceback is raised
    here as a RuntimeError, and no process outlives the call."""
    if backend == "nccl" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"an NCCL world of {world_size} needs "
                           f"{world_size} cards; this host has "
                           f"{torch.cuda.device_count()}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out: List[Any] = [None] * world_size
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world_size, backend,
                                   os.path.join(tmp, "rendezvous"), fn, args,
                                   results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            pending = set(range(world_size))
            while pending:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank died (exit codes "
                                           f"{dead}) without a result")
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"the world of {world_size} did "
                                           f"not finish in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{payload}")
                out[rank] = pickle.loads(payload)
                pending.discard(rank)
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    return out
