"""The Gram row-sharded over the mesh and the distributed blocked Cholesky
(counterpart of ``gaussian_processes_tpu/parallel/sharded_linalg.py``).

* ``sharded_gram``: each rank smooths its rows of x once and builds its
  row block of K (and Kvec) against the inducing images, which every rank
  holds whole, as it holds K_tilde: on the card through the Gram kernel.
* ``distributed_cholesky``: the JAX package's right-looking fan-out block
  Cholesky, step for step.  The matrix is split into P row blocks of
  nb = ceil(n / P) rows, padded with an identity block to nb P; at step k
  the owner's updated diagonal block is broadcast, every rank factors it
  and solves its panel, one all-gather of the (nb, nb) panels feeds the
  trailing update of the columns past the block.  Each rank returns its
  row block of L (at n = 50,000 the float32 factor is 10 GB).
* ``distributed_cholesky_solve``: A x = b from the row blocks of L, by one
  all-gather of L and two triangular solves (b small: ntilde-scale
  right-hand sides).

The products and factorizations are the plain ones the JAX package leaves
to XLA: cuBLAS and cuSOLVER through ``torch.linalg`` on the card.  The
collectives are counted in ``parallel/collectives.calls``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .collectives import all_gather, broadcast
from .mesh import check_device, row_range


def sharded_gram(theta, x: torch.Tensor, xtilde: torch.Tensor,
                 n_px_side: int, mesh, shared: bool = False,
                 axis: str = "data"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``gram_matrices`` with the rows of x split over ``mesh[axis]`` as
    ``torch.tensor_split`` splits them: ``(K_tilde, K, Kvec)`` with K_tilde
    whole and K, Kvec this rank's rows.  Every rank passes the whole x
    (on the mesh's device type, else ValueError).  ``shared``: xtilde is
    x, and K is this rank's rows of K_tilde."""
    from ..ops.kernels import gram_matrices

    check_device(mesh, x)
    sub = mesh[axis]
    rows = row_range(x.shape[0], sub.size(), sub.get_local_rank())
    theta = {k: torch.as_tensor(v, dtype=x.dtype, device=x.device)
             for k, v in theta.items()}
    if shared:
        K_tilde, _, Kvec = gram_matrices(theta, xtilde, xtilde, n_px_side,
                                         shared=True)
        return K_tilde, K_tilde[rows], Kvec[rows]
    return gram_matrices(theta, x[rows], xtilde, n_px_side, shared=False)


def block_rows(n: int, mesh, axis: str = "data") -> slice:
    """This rank's rows of an n x n matrix in ``distributed_cholesky``'s
    layout: block k holds rows [k nb, (k + 1) nb) of the matrix padded to
    nb P rows (nb = ceil(n / P)), cut at n (the last blocks may be short,
    or empty)."""
    sub = mesh[axis]
    nb = -(-n // sub.size())
    k = sub.get_local_rank()
    return slice(min(k * nb, n), min((k + 1) * nb, n))


def distributed_cholesky(A: torch.Tensor, mesh, axis: str = "data",
                         jitter: float = 0.0) -> torch.Tensor:
    """This rank's row block of the lower Cholesky factor of the symmetric
    positive definite n x n matrix whose row block ``A`` (``block_rows``'s
    rows, all n columns) this rank passes.  ``jitter`` is added to the
    diagonal in place.  A is consumed: its buffer holds the result when n
    divides by the axis, a padded copy is factored when it does not.
    Returns the (rows, n) block; the padding factors to identity and is
    cut away.  A non-positive-definite block raises on every rank alike
    (each factors the same broadcast block)."""
    check_device(mesh, A, "A")
    sub = mesh[axis]
    group, p, me = sub.get_group(), sub.size(), sub.get_local_rank()
    n = A.shape[1]
    nb = -(-n // p)
    npad = nb * p
    lo = me * nb
    real = block_rows(n, mesh, axis)
    if A.shape[0] != real.stop - real.start:
        raise ValueError(f"A holds {A.shape[0]} rows; rank {me} of {p} owns "
                         f"rows {real.start}:{real.stop} of {n}")
    with torch.no_grad():
        nr = real.stop - real.start
        # the jitter on this block's entries of the diagonal, in place
        A.diagonal(offset=real.start).add_(jitter)
        if npad == n:
            W = A
        else:
            # identity padding: padded rows and columns factor to identity
            W = torch.zeros((nb, npad), dtype=A.dtype, device=A.device)
            W[:nr, :n] = A
            W[nr:].diagonal(offset=lo + nr).fill_(1.0)
        for k in range(p):
            c0, c1 = k * nb, (k + 1) * nb
            # the owner's diagonal block, already updated by steps < k
            diag = (W[:, c0:c1].contiguous() if me == k else
                    torch.empty((nb, nb), dtype=W.dtype, device=W.device))
            Lkk = torch.linalg.cholesky(broadcast(diag, k, group))
            if me > k:
                # L_ik = A_ik Lkk^-T
                panel = torch.linalg.solve_triangular(
                    Lkk.mT, W[:, c0:c1], upper=True, left=False)
            elif me == k:
                panel = Lkk
            else:
                panel = torch.zeros_like(Lkk)
            # block column k of L, in the columns no later step reads
            W[:, c0:c1] = panel
            if k == p - 1:
                break
            below = torch.cat(all_gather(panel, group)[k + 1:])
            if me > k:
                W[:, c1:] -= panel @ below.mT
        return W[:nr, :n]


def distributed_cholesky_solve(L_rows: torch.Tensor, b: torch.Tensor, mesh,
                               axis: str = "data") -> torch.Tensor:
    """The solution x of A x = b, on every rank, from this rank's row block
    ``L_rows`` of A's lower Cholesky factor (``distributed_cholesky``'s
    layout): one all-gather of L, then the two triangular solves.  ``b``
    (n,) or (n, k), the same on every rank."""
    check_device(mesh, L_rows, "L_rows")
    sub = mesh[axis]
    n = L_rows.shape[1]
    nb = -(-n // sub.size())
    pad = nb - L_rows.shape[0]
    if pad:
        L_rows = torch.cat([L_rows, L_rows.new_zeros((pad, n))])
    L = torch.cat(all_gather(L_rows, sub.get_group()))[:n]
    rhs = b[:, None] if b.dim() == 1 else b
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[:, 0] if b.dim() == 1 else x
