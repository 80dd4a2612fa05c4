"""Ritz-deflation recycling for the PCG solve path.

The reference amortizes one Cholesky factorization over every solve of the
analysis (``source code/fcVM.py:1120-1135, 1400-1406``).  The matrix-free
analogue: amortize *spectral* information.  Every PCG solve implicitly runs
a preconditioned Lanczos process whose vectors are already computed; storing
them costs one (nstore, ndof) buffer and the tridiagonal coefficients.  The
lowest Ritz vectors of ``M^-1 K`` span the slow subspace that dominates the
iteration count, and applying them as a second coarse correction

    z = M^-1 r + W (W^T K W)^-1 W^T r

(the same additive structure as the geometric two-level coarse space, but
spectrally exact) removes it.

Iteration counts on the 499k-dof bench operator
(tools/deflate_step_probe.py); wall times on the H100 are open measurements:

- **the Ritz space is rhs-specific**: Lanczos only converges eigenpairs
  present in the starting vector, so a space harvested from the elastic
  (load-rhs) solve cuts elastic re-solves 58 -> 39 but does NOTHING for
  plastic-residual solves (56 -> 57 + overhead).  A space harvested from
  a plastic-residual solve cuts fresh residual solves 56 -> 40 iters
  and a re-solve of the same rhs to 30.
- **harvesting every step** spends a 56-iter undeflated harvest solve per
  step, which ate the in-step savings.  Hence the production policy
  (``runtime/driver.harvesting_solve``): harvest ONE correction solve,
  retain the space across load steps (re-Galerkin on tangent refresh,
  :func:`fcvm_tpu.runtime.system.regalerkin_deflation`), and drop it only
  when a deflated solve regresses past ``config.deflation_refresh_iters``
  — one harvest amortizes over many steps.
- deflation-as-initial-guess only (``runtime/system.deflation_x0``:
  project the rhs onto the space, run plain CG) saves the per-iteration
  correction cost but converges slower (44 iters vs 40 — the slow modes
  re-enter through rounding); k=16 matches k=32's 40 iters but keeps
  half the spectral band, so k=32 stays the default for cross-step
  robustness.
- k must stay at the single-pass 32: a second pass on the deflated
  operator captures a band that helps only the harvested rhs (measured:
  combined k=64 on a fresh NR rhs is 45 vs 40 for k=32 — overfit);
- the per-iteration cost of the correction is a read of the (ndof, k)
  basis, linear in k;
- solves below ``config.deflation_min_iters`` skip the build: no headroom,
  and on small meshes the correction flattens CG's convergence tail so
  solutions land marginally under rtol, which measurably slows modified
  NR (restart spirals at tight error_max).

The deflation preconditioner stays SPD for ANY SPD ``kw_inv`` (sum of an
SPD and a PSD term), so a stale Galerkin matrix after a tangent refresh can
degrade convergence but never break CG; the driver still re-Galerkins
against each new tangent operator because one block ``K @ W`` reuses the
matvec's gathers for all k columns at once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fcvm_tpu.ops import assembly as asm


class DeflationSpace(NamedTuple):
    """Deflation basis + Galerkin inverse, in the space CG runs in."""

    w: jnp.ndarray       # (ndof, k) basis (zero on fixed dofs)
    kw_inv: jnp.ndarray  # (k, k) pseudo-inverse of W^T K_hat W


def deflated(precond, defl: Optional[DeflationSpace]):
    """Wrap a preconditioner apply with the deflation correction.

    The (ndof, k) projections run at HIGHEST matmul precision: the
    correction must cancel the slow modes it targets to better than the
    CG tolerance, and a reduced-precision default's ~1e-3 relative noise
    in ``W (W^T K W)^+ W^T r`` floors the deflated solves (at 499k dof,
    deflated plastic solves pinned at 42 iters vs 29-38 expected).
    """
    if defl is None:
        return precond

    def apply(r):
        with jax.default_matmul_precision("highest"):
            return precond(r) + defl.w @ (defl.kw_inv @ (defl.w.T @ r))

    return apply


def ritz_coefficients(
    alphas, betas, rzs, iters: int, k: int, ghost_rtol: float = 1.0e-4
):
    """Host-side Ritz extraction from stored PCG coefficients.

    Builds the Lanczos tridiagonal ``T`` of the preconditioned operator
    from the CG alpha/beta recurrence (Saad, Iterative Methods, sec. 6.7),
    drops ghost duplicates (re-converged copies of an eigenpair, an
    artifact of finite-precision Lanczos), and returns the combination
    coefficients of the ``k`` lowest Ritz vectors in the stored
    preconditioned residuals: ``W = Z.T @ coef`` with
    ``v_j = (-1)^j z_j / sqrt(r_j^T z_j)``.

    The result is zero-padded to a FIXED ``(nstore, k)`` shape so every
    downstream device computation compiles exactly once per mesh (the
    harvest length varies step to step; a shape-polymorphic build would
    recompile every time).  Zero columns make
    zero ``W`` columns, which the PSD pseudo-inverse of the Galerkin
    matrix ignores.

    Expects HOST arrays (fetch the harvest coefficients with a single
    ``jax.device_get`` — per-array fetches cost a device round-trip each).
    Returns ``None`` when fewer than 3 valid iterations are available.
    """
    nstore = int(np.asarray(alphas).shape[0])
    m = min(int(iters), nstore - 2)
    if m < 3:
        return None
    a = np.asarray(alphas)[:m].astype(np.float64)
    bt = np.asarray(betas)[:m].astype(np.float64)
    rz = np.asarray(rzs)[:m].astype(np.float64)
    if not (np.all(np.isfinite(a)) and np.all(a > 0.0)
            and np.all(np.isfinite(bt)) and np.all(bt >= 0.0)
            and np.all(rz > 0.0)):
        return None
    diag = np.empty(m)
    off = np.empty(m - 1)
    diag[0] = 1.0 / a[0]
    for j in range(1, m):
        diag[j] = 1.0 / a[j] + bt[j - 1] / a[j - 1]
        off[j - 1] = np.sqrt(bt[j - 1]) / a[j - 1]
    t = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    evals, evecs = np.linalg.eigh(t)
    keep = []
    for j in range(m):
        if all(
            abs(evals[j] - evals[i]) > ghost_rtol * max(abs(evals[j]), 1e-30)
            for i in keep
        ):
            keep.append(j)
        if len(keep) >= k:
            break
    sgn = (-1.0) ** np.arange(m)
    scale = sgn / np.sqrt(rz)
    coef = np.zeros((nstore, k), dtype=np.float32)
    coef[:m, : len(keep)] = scale[:, None] * evecs[:, np.asarray(keep)]
    return coef


@jax.jit
def build_w(zs, coef, fixmask):
    """(ndof, k) deflation basis from stored residuals + Ritz coefficients.

    Fixed dofs are masked out so the correction acts on the free subspace
    only (K_hat is identity there and x0 seeds fixed dofs exactly)."""
    m = coef.shape[0]
    w = jnp.einsum("mn,mk->nk", zs[:m], coef.astype(zs.dtype),
                   precision=jax.lax.Precision.HIGHEST)
    return fixmask[:, None] * w


def block_khat_matvec(esm, eldofs, fixmask, plan, w):
    """``K_hat @ W`` for a (ndof, k) block of vectors in ONE pass.

    Gather cost is per-index and independent of row width (measured:
    48 B rows price the same as 12 B), so k columns cost ~1.2x a single
    matvec instead of k times — the fact that makes recycling cheap.
    Column axis stays LAST so each node row is a contiguous (3, k) slice.
    """
    ne = esm.shape[0]
    elnodes = eldofs[:, ::3] // 3
    nn = fixmask.shape[0] // 3
    k = w.shape[1]
    wp = fixmask[:, None] * w
    u3k = wp.reshape(nn, 3, k)[elnodes]  # (ne, 10, 3, k) row gather
    esm4 = esm.reshape(ne, 10, 3, 30)
    # HIGHEST: K W feeds the Galerkin matrix whose inverse must cancel the
    # deflated modes below CG tolerance (see `deflated`); per-harvest cost
    fe = jnp.einsum(
        "eabj,ejk->eabk", esm4, u3k.reshape(ne, 30, k),
        precision=jax.lax.Precision.HIGHEST,
    )
    if plan is not None:
        out = asm.scatter_node_rows(fe.reshape(ne * 10, 3, k), plan)
    else:
        out = jax.ops.segment_sum(
            fe.reshape(ne * 10, 3, k), elnodes.reshape(-1), num_segments=nn
        )
    kw_free = fixmask[:, None] * out.reshape(nn * 3, k)
    return kw_free + (1.0 - fixmask)[:, None] * w


@jax.jit
def galerkin(esm, eldofs, fixmask, plan, w):
    """(k, k) Galerkin matrix ``W^T K_hat W`` on the current operator."""
    with jax.default_matmul_precision("highest"):
        return w.T @ block_khat_matvec(esm, eldofs, fixmask, plan, w)


def pinv_psd(kw):
    """On-device PSD pseudo-inverse of the (k, k) Galerkin matrix.

    pinv (not inv): near-converged Ritz pairs from successive harvests can
    be nearly dependent (and zero-padded coefficient columns make exactly
    singular blocks); the pseudo-inverse keeps the correction PSD.  Fully
    traceable so the whole space build fuses into one jit (no host
    round-trip per step).  The eigh runs in the input dtype: f64 inputs
    keep f64 on every backend."""
    rcond = 1.0e-10 if kw.dtype == jnp.float64 else 1.0e-5
    evals, evecs = jnp.linalg.eigh(0.5 * (kw + kw.T))
    cutoff = rcond * jnp.max(jnp.abs(evals))
    good = evals > cutoff
    inv = jnp.where(good, 1.0 / jnp.where(good, evals, 1.0), 0.0)
    return jnp.matmul(evecs * inv[None, :], evecs.T,
                      precision=jax.lax.Precision.HIGHEST)


def build_space(esm, eldofs, fixmask, plan, zs, coef):
    """Fused (traceable) deflation-space build: Z,coef -> (W, (W^T K W)^+).

    One device program per mesh: basis combination, block Galerkin matvec
    and the PSD pseudo-inverse all stay on device; the only host work per
    step is the tiny tridiagonal eigendecomposition in
    :func:`ritz_coefficients`."""
    with jax.default_matmul_precision("highest"):
        w = fixmask[:, None] * jnp.einsum(
            "mn,mk->nk", zs, coef.astype(zs.dtype)
        )
        kw = w.T @ block_khat_matvec(esm, eldofs, fixmask, plan, w)
    return DeflationSpace(w, pinv_psd(kw))
