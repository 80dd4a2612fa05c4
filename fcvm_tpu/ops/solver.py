"""Device-resident linear solvers.

The reference factorizes the sparse global stiffness matrix with one of three
host Cholesky backends (``source code/fcVM.py:66-71, 1120-1135``).  Here the
primary backend is a matrix-free preconditioned conjugate-gradient solver
whose ``K @ v`` is the gather/block-matmul/scatter operator from
:mod:`fcvm_tpu.ops.assembly` and whose preconditioner is the 3x3 nodal
block-Jacobi inverse.  The whole Krylov loop runs on device inside
``lax.while_loop``; only the converged solution crosses back to the host.

A scipy sparse-direct backend is kept for CPU validation/debugging, mirroring
the reference's backend-selection tier.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class CGResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    relres: jnp.ndarray


class HarvestData(NamedTuple):
    """Lanczos byproducts of a PCG solve (see ``fcvm_tpu.ops.deflation``).

    Slots beyond ``min(iters, nstore-2)`` may be clobbered when the solve
    runs longer than the buffer; ``ritz_coefficients`` only reads the valid
    prefix."""

    zs: jnp.ndarray      # (nstore, n) preconditioned residuals z_j
    rzs: jnp.ndarray     # (nstore,) r_j^T z_j
    alphas: jnp.ndarray  # (nstore,) CG step lengths
    betas: jnp.ndarray   # (nstore,) CG direction updates


def pcg(
    matvec: Callable,
    b: jnp.ndarray,
    precond: Optional[Callable] = None,
    x0: Optional[jnp.ndarray] = None,
    rtol: float = 1.0e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    stall: int = 0,
    dot: Optional[Callable] = None,
) -> CGResult:
    """Preconditioned conjugate gradients (jit/vmap/shard_map friendly).

    Replaces the reference's ``factor(f)`` triangular solves
    (``fcVM.py:1130, 1400-1406``) as the per-Newton-iteration hot op.

    ``stall > 0`` adds a stagnation exit: stop once the residual norm has
    not improved by >0.1% for ``stall`` consecutive iterations.  This is
    how callers that want "as accurate as the arithmetic allows" (the
    buckling eigensolve at rtol 1e-10) avoid burning ``maxiter`` when the
    dtype's residual floor sits above ``rtol`` — the solve runs to ITS OWN
    floor and exits ~``stall`` iterations later, instead of either
    grinding to maxiter (f32 floor > 1e-10) or stopping at a fixed floored
    tolerance that is 100x sloppier than the arithmetic can deliver
    (measured: a 6e-6 f32 rtol floor cost 8% eigenvalue error on the
    Euler-column example; the true f32 floor gives ~1%).

    ``dot`` overrides the inner product (default ``jnp.vdot``); the
    node-partitioned sharded solver passes a psum-reduced local dot so the
    whole loop can run inside ``shard_map`` on row slices.
    """
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if dot is None:
        dot = jnp.vdot
        norm = jnp.linalg.norm
    else:
        norm = lambda v: jnp.sqrt(dot(v, v))

    bnorm = norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)
    stall_lim = int(stall) if stall and stall > 0 else int(maxiter) + 1
    # the stagnation exit only arms once the solve is in the converging
    # regime (residual 1e3 below ||b||); a genuinely stuck solve keeps the
    # conservative run-to-maxiter behavior
    stall_gate = 1.0e-3 * bnorm

    r0 = b - matvec(x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    rn0 = norm(r0)

    def cond(state):
        _, _, _, _, k, rnorm, _, since = state
        stalled = jnp.logical_and(since >= stall_lim, rnorm < stall_gate)
        return jnp.logical_and(
            jnp.logical_and(rnorm > tol, k < maxiter),
            jnp.logical_not(stalled),
        )

    def body(state):
        x, r, p, rz, k, _, best, since = state
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = rz / jnp.where(pap == 0.0, 1.0, pap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
        p = z + beta * p
        rnorm = norm(r)
        improved = rnorm < 0.999 * best
        since = jnp.where(improved, 0, since + 1)
        best = jnp.minimum(best, rnorm)
        return (x, r, p, rz_new, k + 1, rnorm, best, since)

    init = (x0, r0, p0, rz0, jnp.array(0, jnp.int32), rn0, rn0,
            jnp.array(0, jnp.int32))
    x, r, _, _, k, rnorm, _, _ = jax.lax.while_loop(cond, body, init)
    return CGResult(x, k, rnorm / jnp.where(bnorm == 0.0, 1.0, bnorm))


def pcg_harvest(
    matvec: Callable,
    b: jnp.ndarray,
    precond: Optional[Callable] = None,
    x0: Optional[jnp.ndarray] = None,
    rtol: float = 1.0e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    nstore: int = 64,
    stall: int = 0,
):
    """:func:`pcg` that also records its Lanczos byproducts.

    Identical iteration to :func:`pcg` (same convergence criterion incl.
    the optional ``stall`` stagnation exit, same update order);
    additionally stores the first ``nstore`` preconditioned residuals and
    the alpha/beta coefficients so the caller can extract Ritz vectors for
    deflation recycling (``fcvm_tpu.ops.deflation``).
    Returns ``(CGResult, HarvestData)``.
    """
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)

    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)
    stall_lim = int(stall) if stall and stall > 0 else int(maxiter) + 1
    stall_gate = 1.0e-3 * bnorm  # see pcg

    r0 = b - matvec(x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)
    rn0 = jnp.linalg.norm(r0)
    n = b.shape[0]
    h0 = HarvestData(
        jnp.zeros((nstore, n), b.dtype).at[0].set(z0),
        jnp.zeros((nstore,), b.dtype).at[0].set(rz0),
        jnp.zeros((nstore,), b.dtype),
        jnp.zeros((nstore,), b.dtype),
    )
    cap = nstore - 1

    def cond(state):
        _, _, _, _, k, rnorm, _, since, _ = state
        stalled = jnp.logical_and(since >= stall_lim, rnorm < stall_gate)
        return jnp.logical_and(
            jnp.logical_and(rnorm > tol, k < maxiter),
            jnp.logical_not(stalled),
        )

    def body(state):
        x, r, p, rz, k, _, best, since, h = state
        ap = matvec(p)
        pap = jnp.vdot(p, ap)
        alpha = rz / jnp.where(pap == 0.0, 1.0, pap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
        p = z + beta * p
        kc = jnp.minimum(k, cap)
        kc1 = jnp.minimum(k + 1, cap)
        h = HarvestData(
            jax.lax.dynamic_update_index_in_dim(h.zs, z, kc1, 0),
            h.rzs.at[kc1].set(rz_new),
            h.alphas.at[kc].set(alpha),
            h.betas.at[kc].set(beta),
        )
        rnorm = jnp.linalg.norm(r)
        improved = rnorm < 0.999 * best
        since = jnp.where(improved, 0, since + 1)
        best = jnp.minimum(best, rnorm)
        return (x, r, p, rz_new, k + 1, rnorm, best, since, h)

    init = (x0, r0, p0, rz0, jnp.array(0, jnp.int32), rn0, rn0,
            jnp.array(0, jnp.int32), h0)
    x, r, _, _, k, rnorm, _, _, h = jax.lax.while_loop(cond, body, init)
    return CGResult(x, k, rnorm / jnp.where(bnorm == 0.0, 1.0, bnorm)), h


# ---------------------------------------------------------------------------
# Host-side scipy direct backend (validation / CPU fallback)
# ---------------------------------------------------------------------------


def assemble_scipy_csc(esm, eldofs, fixmask, ndof):
    """Assemble ``K_hat`` as a scipy CSC matrix from the element blocks.

    Used only for cross-validation against the CG path and as the ``scipy``
    solver backend on CPU.  Applies the same Dirichlet elimination as
    :func:`fcvm_tpu.ops.assembly.make_bc_matvec`.
    """
    import scipy.sparse as sp

    esm = np.asarray(esm)
    eldofs = np.asarray(eldofs)
    fixmask = np.asarray(fixmask)
    ne = esm.shape[0]
    rows = np.repeat(eldofs, 30, axis=1).reshape(-1)
    cols = np.tile(eldofs, (1, 30)).reshape(-1)
    vals = esm.reshape(-1)
    free = fixmask > 0.5
    keep = free[rows] & free[cols]
    k = sp.coo_matrix(
        (vals[keep], (rows[keep], cols[keep])), shape=(ndof, ndof)
    ).tocsc()
    fixed_idx = np.where(~free)[0]
    k = k + sp.coo_matrix(
        (np.ones(len(fixed_idx)), (fixed_idx, fixed_idx)), shape=(ndof, ndof)
    ).tocsc()
    return k


class ScipyDirectSolver:
    """LU-factorized host solve, mirroring the reference's Cholesky tier."""

    def __init__(self, esm, eldofs, fixmask, ndof):
        from scipy.sparse.linalg import splu

        self._lu = splu(assemble_scipy_csc(esm, eldofs, fixmask, ndof))

    def solve(self, b):
        return jnp.asarray(self._lu.solve(np.asarray(b)))
