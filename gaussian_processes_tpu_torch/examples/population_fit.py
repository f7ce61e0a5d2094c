"""Population fit: every cell of the dataset in one batched program, on
one device or over a ("cells", "data") mesh of ranks
(counterpart of ``examples/population_fit.py``).

    python -m gaussian_processes_tpu_torch population [--ncells 8]
        [--device cpu]
    torchrun --nproc-per-node 4 -m gaussian_processes_tpu_torch population \
        --mesh-cells 2 --mesh-data 2

Under ``torchrun`` (or with a mesh flag) every rank joins the process group
torchrun describes -- NCCL on the cards, gloo with ``--device cpu`` -- and
fits its share; rank 0 prints.
"""

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..config import FitConfig, resolve_device
from ..data import synthetic_retina
from ..parallel import fit_population, make_mesh


def main(argv=None):
    """Run the workflow; returns the cell-stacked carry."""
    ap = argparse.ArgumentParser(
        prog="gaussian_processes_tpu_torch population")
    ap.add_argument("--ncells", type=int, default=8)
    ap.add_argument("--n-px", type=int, default=54)
    ap.add_argument("--nt", type=int, default=400)
    ap.add_argument("--ntilde", type=int, default=200)
    ap.add_argument("--maxiter", type=int, default=5)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh-cells", type=int, default=None)
    ap.add_argument("--mesh-data", type=int, default=None)
    args = ap.parse_args(argv)

    device = resolve_device(None, args.device)
    if (args.mesh_cells or args.mesh_data
            or int(os.environ.get("WORLD_SIZE", "1")) > 1):
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        try:
            return _fit(args, device, make_mesh(args.mesh_cells,
                                                args.mesh_data))
        finally:
            dist.destroy_process_group()
    return _fit(args, device, None)


def _fit(args, device, mesh):
    """The fit of ``main``'s dataset (on ``mesh`` when one is given)."""
    say = mesh is None or dist.get_rank() == 0
    if mesh is not None and say:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
    ds = synthetic_retina(n_px_side=args.n_px, n_train=args.nt, n_val=10,
                          n_test=10, n_repeats=10, n_cells=args.ncells,
                          seed=0)
    X, R = ds.full_train()
    X = torch.as_tensor(X, device=device)
    R = torch.as_tensor(R.T, device=device)      # (ncells, nt)

    cfg = FitConfig(ntilde=min(args.ntilde, X.shape[0]),
                    maxiter=args.maxiter, n_estep=5, n_mstep=3,
                    n_fparamstep=5, n_px_side=args.n_px,
                    track_variational=False)

    t0 = time.perf_counter()
    carry, _ = fit_population(X, R, cfg, mesh=mesh)
    loss = -carry.track.logmarginal.cpu().numpy()    # waits for the device
    elapsed = time.perf_counter() - t0
    if say:
        print(f"{args.ncells} cells fit in {elapsed:.2f}s "
              f"({elapsed / args.ncells:.2f}s/cell)")
        for c in range(args.ncells):
            print(f"  cell {c}: loss {loss[c, 0]:.1f} -> {loss[c, -1]:.1f}"
                  f"  failed={bool(carry.failed[c])}")
    return carry


if __name__ == "__main__":
    main()
