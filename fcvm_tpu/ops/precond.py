"""Preconditioners for the matrix-free CG solver.

Two levels:

* **Block-Jacobi** — inverse 3x3 nodal diagonal blocks
  (:func:`fcvm_tpu.ops.assembly.block_jacobi_inverse_blocks`), rebuilt with
  every tangent refresh.
* **Two-level aggregation coarse correction** — nodes are aggregated into
  index-contiguous clusters; each cluster carries the 6 rigid-body modes
  (translations + rotations about the cluster centroid).  The coarse
  operator ``K_c = P^T K_hat P`` is assembled directly from the element
  blocks and inverted densely on device once; the per-iteration coarse
  correction is ``z += P K_c^{-1} P^T r``.

  Because clusters are index-contiguous, ``P`` / ``P^T`` are reshapes +
  einsums over a precomputed (nn, 3, 6) rigid-mode basis — no gather or
  scatter appears anywhere in the apply path, which is what keeps the
  correction cheap next to the matvec.

Index-contiguous clusters are only effective when contiguous node ranges
are *spatially compact*.  The solver therefore runs CG in a Morton-ordered
"solve space" (:class:`fcvm_tpu.runtime.system.SolveSpace`) and builds this
preconditioner on the Morton-permuted operator: the compact clusters cut
the 500k-dof elastic solve from 385 to 87 CG iterations, and a slender-bar
solve from 16.4k to 1.4k.

This is the matrix-free replacement for the spectral role of the reference's
sparse Cholesky factorization (``fcVM.py:66-71``): global (long-wavelength)
error is killed by the coarse solve, local error by the nodal blocks.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from fcvm_tpu.ops import assembly as asm


# Observability for the coarse-build degradation paths (ridge-ladder
# escalation, zero-coarse fallback).  Both are graceful — the solver stays
# correct — but the fallback costs 4-7x CG iterations, so callers (the
# collapse driver) surface these counters in cg_stats and the run log
# instead of relying on a one-shot Python warning nobody reads.
COARSE_BUILD_STATS = {
    "builds": 0,
    "ridge_escalations": 0,  # builds that needed a ridge above the first
    "zero_coarse_fallbacks": 0,  # builds that gave up (fine smoother only)
    "last_escalations": 0,  # ladder steps the most recent build climbed
    "last_fallback": False,
}

# Base ridge 3e-5 chosen on the 499k-dof bench operator with the
# HIGHEST-precision Galerkin accumulate: 51 elastic CG iters vs 53 at 3e-4
# (and 51 at 3e-6 — the knee).  The old 3e-4 base predates the accurate
# kc; it was masking reduced-precision pair-block noise, not true
# accumulation error.
_RIDGE_LADDER = (3.0e-5, 3.0e-4, 3.0e-3, 3.0e-2, 3.0e-1)


def invert_coarse_with_ladder(kc, dtype, label=""):
    """Dense coarse inverse with the escalating ridge ladder.

    The f32 Galerkin accumulation cancels heavily (rigid modes nearly
    annihilate K rows), so the scaled coarse matrix can come out slightly
    indefinite and break the on-device Cholesky (observed min eig -6e-4 at
    28k dofs).  Escalate the ridge until the inverse is finite —
    host-side retry, no jit recompile (ridge is a traced scalar).  If every
    ridge fails, fall back to a zero coarse correction (fine smoother only)
    and record it in :data:`COARSE_BUILD_STATS` so the driver can be loud
    about the degradation.
    """
    stats = COARSE_BUILD_STATS
    stats["builds"] += 1
    coarse_inv = None
    for i, ridge in enumerate(_RIDGE_LADDER):
        coarse_inv = coarse_invert(kc, jnp.asarray(ridge, dtype))
        if bool(jnp.all(jnp.isfinite(coarse_inv))):
            stats["last_escalations"] = i
            stats["last_fallback"] = False
            if i:
                stats["ridge_escalations"] += 1
            return coarse_inv
    import warnings

    stats["last_escalations"] = len(_RIDGE_LADDER)
    stats["last_fallback"] = True
    stats["zero_coarse_fallbacks"] += 1
    warnings.warn(
        f"{label}two-level coarse inverse non-finite at every ridge; "
        "continuing with the fine-level smoother only"
    )
    return jnp.zeros_like(coarse_inv)


class TwoLevelPrecond(NamedTuple):
    pinv: jnp.ndarray  # (nn, 3, 3) block-Jacobi inverses
    qmat: jnp.ndarray  # (nn_pad, 3, nm) cluster mode basis per node
    coarse_inv: jnp.ndarray  # (nm ncl, nm ncl) dense inverse of P^T K P
    fixmask: jnp.ndarray  # (ndof,)
    # optional cluster block-Cholesky smoother (ncl_s, 3 cs, 3 cs); replaces
    # the block-Jacobi fine-level apply when present
    smooth_inv: Optional[jnp.ndarray] = None

    def apply(self, r):
        if self.smooth_inv is not None:
            m = self.smooth_inv.shape[1]
            z = jnp.einsum(
                "cij,cj->ci", self.smooth_inv,
                (self.fixmask * r).reshape(-1, m),
            ).reshape(-1) * self.fixmask
        else:
            z = asm.apply_block_precond(self.pinv, r)
        nn_pad = self.qmat.shape[0]
        nm = self.qmat.shape[2]
        ncl = self.coarse_inv.shape[0] // nm
        cs = nn_pad // ncl
        r3 = (self.fixmask * r).reshape(-1, 3)
        pad = nn_pad - r3.shape[0]
        r3p = jnp.pad(r3, ((0, pad), (0, 0)))
        # P^T r: project onto cluster modes and sum within clusters.  The
        # coarse inverse lives in mode-major dof order (k * ncl + i) — that
        # layout lets the Galerkin build avoid a (ncl, ncl, nm, nm)
        # intermediate with small trailing dims, which tile poorly.
        # HIGHEST precision: the coarse correction exists to cancel the
        # smooth error modes below CG's tolerance; a reduced-precision
        # default re-injects them at ~1e-3 relative (same argument as the
        # deflation apply, ops/deflation.deflated).
        hp = jax.lax.Precision.HIGHEST
        rc = jnp.einsum("nak,na->nk", self.qmat, r3p, precision=hp)
        rc = rc.reshape(ncl, cs, nm).sum(axis=1)  # (ncl, nm)
        with jax.default_matmul_precision("highest"):
            zc = self.coarse_inv @ rc.T.reshape(-1)  # mode-major (nm ncl,)
        zc_cl = zc.reshape(nm, ncl).T  # (ncl, nm)
        zc_n = jnp.repeat(zc_cl[:, None, :], cs, axis=1).reshape(nn_pad, nm)
        z2 = jnp.einsum("nak,nk->na", self.qmat, zc_n, precision=hp)
        z2 = z2[: r3.shape[0]].reshape(-1) * self.fixmask
        return z + z2


def apply_precond(pc, r):
    """Dispatch on the preconditioner pytree (trace-time static)."""
    if isinstance(pc, TwoLevelPrecond):
        return pc.apply(r)
    return asm.apply_block_precond(pc, r)


def refresh_blocks(pc, esm, elnodes, fixmask):
    """Rebuild the block-Jacobi part after a tangent refresh, keeping the
    coarse correction — and the cluster block-Cholesky smoother when present
    — from the elastic operator (a preconditioner only needs to stay SPD and
    spectrally close; cf. modified-NR reuse of the elastic factor in the
    reference, ``fcVM.py:1400-1406``)."""
    if isinstance(pc, TwoLevelPrecond) and pc.smooth_inv is not None:
        return pc  # elastic cluster inverses stay; no per-refresh rebuild
    pinv = asm.block_jacobi_inverse_blocks(esm, elnodes, fixmask)
    if isinstance(pc, TwoLevelPrecond):
        return pc._replace(pinv=pinv)
    return pinv


def _rigid_modes(coords, cluster_size, n_modes: int = 6):
    """(nn_pad, 3, n_modes) cluster mode basis per node, centroid-centered.

    ``n_modes=6``: rigid-body modes (translations + rotations).
    ``n_modes=12``: full affine basis — rigid + the six uniform strain
    fields.  Measured (47k-dof box, cs=111): 77 -> 44 CG iterations at the
    same cluster size, and at *equal coarse dimension* the affine basis
    still wins (52 vs 96 iters) — uniform strains capture the smooth
    elasticity error components rigid modes miss.  The smoothed-aggregation
    prolongator was prototyped on the same operator and rejected: 1.17x
    fewer iterations for ~2x per-iteration apply cost."""
    nn = coords.shape[0]
    ncl = -(-nn // cluster_size)
    nn_pad = ncl * cluster_size
    pad = nn_pad - nn
    cpad = jnp.pad(coords, ((0, pad), (0, 0)))
    centroids = cpad.reshape(ncl, cluster_size, 3).mean(axis=1)
    d = cpad - jnp.repeat(centroids, cluster_size, axis=0)  # (nn_pad, 3)
    z = jnp.zeros(nn_pad, dtype=coords.dtype)
    eye = jnp.eye(3, dtype=coords.dtype)
    trans = jnp.broadcast_to(eye, (nn_pad, 3, 3))
    # rotation modes: u = omega x d -> u_a = eps_abc omega_b d_c, normalized
    # by the cluster rms offset so all six modes have comparable magnitude
    # (keeps cond(K_c) low enough for an f32 apply of the coarse inverse).
    d_rms = jnp.sqrt(
        (d.reshape(ncl, cluster_size, 3) ** 2).mean(axis=(1, 2))
    )  # (ncl,)
    scale = 1.0 / jnp.maximum(jnp.repeat(d_rms, cluster_size), 1e-30)
    dx, dy, dz = d[:, 0] * scale, d[:, 1] * scale, d[:, 2] * scale
    rot = jnp.stack(
        [
            jnp.stack([z, dz, -dy], axis=-1),
            jnp.stack([-dz, z, dx], axis=-1),
            jnp.stack([dy, -dx, z], axis=-1),
        ],
        axis=1,
    )  # (nn_pad, 3, 3): column b = mode omega_b
    parts = [trans, rot]
    if n_modes == 12:
        # uniform strain modes (same rms normalization as rotations):
        # exx, eyy, ezz and the engineering shears exy, exz, eyz
        half = jnp.asarray(0.5, dtype=coords.dtype)
        strain = jnp.stack(
            [
                jnp.stack([dx, z, z, half * dy, half * dz, z], axis=-1),
                jnp.stack([z, dy, z, half * dx, z, half * dz], axis=-1),
                jnp.stack([z, z, dz, z, half * dx, half * dy], axis=-1),
            ],
            axis=1,
        )  # (nn_pad, 3, 6)
        parts.append(strain)
    elif n_modes != 6:
        raise ValueError(f"n_modes must be 6 or 12, got {n_modes}")
    q = jnp.concatenate(parts, axis=2)  # (nn_pad, 3, n_modes)
    # zero the padding nodes so they contribute nothing
    mask = (jnp.arange(nn_pad) < nn).astype(coords.dtype)
    return q * mask[:, None, None]


@partial(jax.jit, static_argnames=("cluster_size", "n_modes"))
def _qmat_bc_jit(coords, fixmask, cluster_size: int, n_modes: int = 6):
    """(ncl*cs, 3, nm) Dirichlet-masked cluster-mode basis (one jit rather
    than many eager dispatches)."""
    nn_pad = fixmask.shape[0] // 3
    nn = coords.shape[0]
    coords_p = jnp.pad(coords, ((0, nn_pad - nn), (0, 0)))
    qmat = _rigid_modes(coords_p, cluster_size, n_modes)
    m3 = jnp.pad(
        fixmask.reshape(nn_pad, 3), ((0, qmat.shape[0] - nn_pad), (0, 0))
    )
    return qmat * m3[:, :, None]


_block_jacobi_jit = jax.jit(asm.block_jacobi_inverse_blocks)


def build_two_level(
    esm: jnp.ndarray,
    elnodes: jnp.ndarray,
    coords: jnp.ndarray,
    fixmask: jnp.ndarray,
    cluster_size: int = 64,
    n_modes: int = 6,
) -> TwoLevelPrecond:
    """Assemble the two-level preconditioner from element blocks, on device.

    All inputs must share one node/element numbering — the driver passes the
    Morton solve-space views so clusters are spatially compact.

    The coarse operator uses the Dirichlet-masked blocks, so it approximates
    ``K_hat`` exactly on the coarse space; near-singular coarse dofs (fully
    constrained clusters) are regularized to identity.

    The Galerkin product is computed per element as ``S_e = Q~ B_e Q~^T``
    with the block-diagonal per-element mode matrix ``Q~ (60, 30)`` — three
    batched matmuls whose intermediates keep >=30-wide trailing dims (a
    naive einsum's (..., 6, 6) tails tile poorly in device memory).  The
    (6, 6) pair blocks then scatter-add into the (ncl^2, 36) coarse layout
    inside a ``lax.scan`` over element chunks; everything stays on device
    (the alternative pulls the 425 MB block array of a 500k-dof mesh to the
    host every build).
    """
    nn_pad = fixmask.shape[0] // 3  # includes dof-alignment padding
    pinv = _block_jacobi_jit(esm, elnodes, fixmask)
    qmat_bc = _qmat_bc_jit(coords, fixmask, cluster_size, n_modes)
    ncl = qmat_bc.shape[0] // cluster_size

    kc = _coarse_accumulate_jit(esm, elnodes, qmat_bc, cluster_size)
    coarse_inv = invert_coarse_with_ladder(kc, esm.dtype)

    smooth_inv = None
    from fcvm_tpu.config import get_config

    cfg = get_config()
    if cfg.smoother == "cluster":
        cs = cfg.smoother_cluster_nodes
        if nn_pad % cs == 0:
            smooth_inv = _cluster_diag_inverse(esm, elnodes, fixmask, cs)
            if bool(jnp.any(jnp.isnan(smooth_inv))):
                smooth_inv = None  # fall back to block-Jacobi
    return TwoLevelPrecond(pinv, qmat_bc, coarse_inv, fixmask, smooth_inv)


def _coarse_accumulate(esm, elnodes, qmat_bc, cluster_size: int, kc0=None):
    """Galerkin pair-block accumulation: (ncl*ncl, 36) coarse layout.

    Pure element-wise + scatter-add — safe to run per shard inside
    ``shard_map`` (each shard accumulates its local elements; a ``psum``
    over the element axis completes the sum; pass a ``pcast``-varying
    ``kc0`` there so the scan carry's manual axes match)."""
    ne = esm.shape[0]
    dtype = esm.dtype
    ncl = qmat_bc.shape[0] // cluster_size
    cid = jnp.arange(qmat_bc.shape[0], dtype=jnp.int32) // cluster_size

    chunk = min(8192, ne)
    nchunks = -(-ne // chunk)
    pad = nchunks * chunk - ne
    # ghost elements: zero blocks on node 0 -> zero contributions to key 0
    esm_p = jnp.concatenate([esm, jnp.zeros((pad, 30, 30), dtype)]) if pad else esm
    eln_p = (
        jnp.concatenate([elnodes, jnp.zeros((pad, 10), elnodes.dtype)])
        if pad
        else elnodes
    )
    eye10 = jnp.eye(10, dtype=dtype)
    nm = qmat_bc.shape[2]

    def body(kc, start):
        esm_c = jax.lax.dynamic_slice_in_dim(esm_p, start, chunk, 0)
        eln_c = jax.lax.dynamic_slice_in_dim(eln_p, start, chunk, 0)
        qe = qmat_bc[eln_c]  # (c, 10, 3, nm)
        # block-diagonal Q~ (c, 10 nm, 30): rows (i, x), cols (j, a)
        qt = jnp.einsum("ciax,ij->cixja", qe, eye10).reshape(
            chunk, 10 * nm, 30
        )
        # HIGHEST matmul precision: the rigid/affine modes nearly annihilate
        # K, so the pair blocks are deep cancellations — at a
        # reduced-precision default their ~4e-3 relative noise dominates
        # the small coarse eigenvalues once the element blocks themselves
        # are exact (formation_precision=highest), breaking the first-ridge
        # Cholesky and escalating the ladder (at 499k dof: 59 -> 78 elastic
        # CG iters, plus the extra inverse attempts).  Build-time cost only.
        with jax.default_matmul_precision("highest"):
            s_blk = qt @ esm_c @ jnp.swapaxes(qt, 1, 2)  # (c, 10nm, 10nm)
        pair = (
            s_blk.reshape(chunk, 10, nm, 10, nm)
            .transpose(0, 1, 3, 2, 4)
            .reshape(chunk * 100, nm * nm)
        )
        ci = cid[eln_c]  # (c, 10)
        keys = (ci[:, :, None] * ncl + ci[:, None, :]).reshape(-1)
        return kc.at[keys].add(pair), None

    if kc0 is None:
        kc0 = jnp.zeros((ncl * ncl, nm * nm), dtype)
    starts = jnp.arange(nchunks, dtype=jnp.int32) * chunk
    kc, _ = jax.lax.scan(body, kc0, starts)
    return kc


_coarse_accumulate_jit = jax.jit(
    _coarse_accumulate, static_argnames=("cluster_size",)
)


@jax.jit
def _coarse_densify_scale(kc, ridge):
    """Dense layout + Jacobi scaling + symmetrize + ridge of the coarse
    pair-block accumulator ``kc`` ((ncl*ncl, nm*nm) -> mode-major
    (n6, n6)); returns ``(kc_scaled, dscale)``.  Shared by the fused
    single-jit inverse and the chunked blocked-Schur large-dim path."""
    dtype = kc.dtype
    ncl = math.isqrt(kc.shape[0])
    nm = math.isqrt(kc.shape[1])
    n6 = nm * ncl
    # Mode-major dense layout D[(a ncl + i), (b ncl + j)] = kc[i ncl + j,
    # nm*a+b]: the only transposes move (ncl, ncl) planes, whose (8, 128)
    # tiling is tight — the naive cluster-major interleave materializes a
    # (ncl, ncl, nm, nm) intermediate that tiles ~21x (9+ GB at ncl = 1500).
    planes = kc.T.reshape(nm, nm, ncl, ncl)  # [a, b, i, j]
    kc_dense = planes.transpose(0, 2, 1, 3).reshape(n6, n6)
    diag = jnp.abs(jnp.diagonal(kc_dense))
    scale = jnp.max(diag)
    diag = jnp.where(diag <= 1e-12 * scale, scale, diag)
    # Symmetric Jacobi scaling keeps the explicit inverse balanced, bounding
    # the f32 cancellation error of the per-iteration coarse matvec.
    dscale = 1.0 / jnp.sqrt(diag)
    kc_scaled = kc_dense * dscale[:, None] * dscale[None, :]
    ii = jnp.arange(n6)
    kc_scaled = kc_scaled.at[ii, ii].set(jnp.maximum(kc_scaled[ii, ii], 1.0))
    # Symmetrize (the chunked f32 accumulation leaves O(3e-4) relative skew)
    # and ridge: index-contiguous clusters can be nearly collinear, leaving
    # a near-null axis-rotation mode whose exploding inverse entries an f32
    # apply cannot cancel.  The ridge bounds ||inv|| by 1/ridge while
    # perturbing healthy modes (diag ~ 1) by O(ridge).
    kc_scaled = 0.5 * (kc_scaled + kc_scaled.T)
    kc_scaled = kc_scaled + ridge * jnp.eye(n6, dtype=dtype)
    return kc_scaled, dscale


@partial(jax.jit, static_argnames=())
def _coarse_densify_invert(kc, ridge):
    """Scale + symmetrize + ridge + f32 Cholesky inversion of the coarse
    pair-block accumulator (the fused <=9.2k^2 path)."""
    dtype = kc.dtype
    kc_scaled, dscale = _coarse_densify_scale(kc, ridge)
    n6 = kc_scaled.shape[0]
    # f32 Cholesky inversion is safe: scaling + ridge bound the condition
    # number by ~1/ridge, and the result is only a preconditioner.  Whether
    # an f64 factorization pays on the H100 is an open measurement.
    kcs32 = kc_scaled.astype(jnp.float32)
    chol = jax.scipy.linalg.cho_factor(kcs32, lower=True)
    inv_scaled = jax.scipy.linalg.cho_solve(chol, jnp.eye(n6, dtype=jnp.float32))
    ds32 = dscale.astype(jnp.float32)
    return (inv_scaled * ds32[:, None] * ds32[None, :]).astype(dtype)


@jax.jit
def _fused_spd_inv32(m):
    """f32 Cholesky inverse of one SPD block (compile-safe to ~9.2k^2)."""
    c = jax.scipy.linalg.cho_factor(m.astype(jnp.float32), lower=True)
    return jax.scipy.linalg.cho_solve(
        c, jnp.eye(m.shape[0], dtype=jnp.float32)
    )


@jax.jit
def _schur_complement(a_inv, b, c):
    # HIGHEST matmul precision: a reduced-precision f32 default leaves
    # O(1e-3) relative error in S = C - B^T A^-1 B, which degraded the
    # 12k-dim coarse preconditioner from 58 to 222 CG iterations.
    with jax.default_matmul_precision("highest"):
        return c.astype(jnp.float32) - b.astype(jnp.float32).T @ (
            a_inv @ b.astype(jnp.float32)
        )


@jax.jit
def _schur_assemble(a_inv, b, s_inv):
    """[[A,B],[B^T,C]]^-1 blocks from A^-1 and the Schur inverse."""
    with jax.default_matmul_precision("highest"):
        w = a_inv @ b.astype(jnp.float32)  # A^-1 B
        tl = a_inv + w @ s_inv @ w.T
        tr = -(w @ s_inv)
    return tl, tr


def _blocked_spd_inverse(m, fused_limit: int):
    """Recursive 2x2 Schur inversion: only <= fused_limit Cholesky solves.

    Written for a compiler that refused the fused Cholesky-solve-with-full-
    identity program past ~9.2k^2; splitting M = [[A, B], [B^T, C]] needs
    only half-size fused inverses plus matmuls.  Whether the H100 needs
    the split at all is an open measurement (one dense Cholesky path
    would replace it)."""
    n = m.shape[0]
    if n <= fused_limit:
        return _fused_spd_inv32(m)
    h = (n + 1) // 2
    a, b, c = m[:h, :h], m[:h, h:], m[h:, h:]
    a_inv = _blocked_spd_inverse(a, fused_limit)
    s = _schur_complement(a_inv, b, c)
    s_inv = _blocked_spd_inverse(s, fused_limit)
    tl, tr = _schur_assemble(a_inv, b, s_inv)
    top = jnp.concatenate([tl, tr], axis=1)
    bot = jnp.concatenate([tr.T, s_inv], axis=1)
    return jnp.concatenate([top, bot], axis=0)


@jax.jit
def _newton_schulz_refine(x, m):
    """Two Newton-Schulz steps ``X <- X (2I - M X)``: pure matmuls that
    square the inverse residual each step.  The f32 blocked-Schur assembly
    leaves ``||I - M X|| ~ 1e-3`` at 12k dimensions (seen as a 58 -> 222
    CG-iteration regression); two refinements put it at f32 roundoff.
    Must run at HIGHEST matmul precision: at a reduced-precision default
    the refinement floor is that precision's roundoff and the steps are a
    no-op (221 iterations, i.e. unchanged)."""
    m32 = m.astype(jnp.float32)
    eye2 = 2.0 * jnp.eye(m.shape[0], dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        for _ in range(2):
            x = x @ (eye2 - m32 @ x)
    return 0.5 * (x + x.T)


def coarse_invert(kc, ridge, large_dim_threshold: int = 9216):
    """Dense coarse inverse; blocked Schur + Newton-Schulz refinement past
    the fused-compile size limit."""
    ncl = math.isqrt(kc.shape[0])
    nm = math.isqrt(kc.shape[1])
    n6 = nm * ncl
    if n6 <= large_dim_threshold:
        return _coarse_densify_invert(kc, ridge)
    kc_scaled, dscale = _coarse_densify_scale(kc, ridge)
    inv_scaled = _blocked_spd_inverse(kc_scaled, large_dim_threshold)
    inv_scaled = _newton_schulz_refine(inv_scaled, kc_scaled)
    ds32 = dscale.astype(jnp.float32)
    return (inv_scaled * ds32[:, None] * ds32[None, :]).astype(kc.dtype)


@partial(jax.jit, static_argnames=("cs",))
def _cluster_diag_inverse(esm, elnodes, fixmask, cs: int):
    """Inverse cluster-diagonal blocks of ``K_hat``: (ncl, 3 cs, 3 cs).

    Clusters are index-contiguous node ranges (compact in the Morton solve
    space), so the apply is a reshape plus one batched matmul.  The blocks
    are principal submatrices of the SPD ``K_hat`` (identity on fixed
    dofs), so the batched Cholesky inversion is safe.  The path is
    default-off (``config.smoother``): on the accelerator the solver was
    first tuned for, its build and apply cost more than the iterations
    they save.  On the H100 that is an open measurement.
    """
    ne = esm.shape[0]
    dtype = esm.dtype
    nn_pad = fixmask.shape[0] // 3
    assert nn_pad % cs == 0, "dof padding must be a multiple of 3*cs"
    ncl = nn_pad // cs
    m = 3 * cs

    chunk = min(4096, ne)
    nchunks = -(-ne // chunk)
    pad = nchunks * chunk - ne
    esm_p = jnp.concatenate([esm, jnp.zeros((pad, 30, 30), dtype)]) if pad else esm
    eln_p = (
        jnp.concatenate([elnodes, jnp.zeros((pad, 10), elnodes.dtype)])
        if pad
        else elnodes
    )
    nrow = ncl * m * (m // 3)  # flat (cluster, row, col-node) 3-wide segments
    a3 = jnp.arange(3, dtype=jnp.int32)

    def body(acc, start):
        esm_c = jax.lax.dynamic_slice_in_dim(esm_p, start, chunk, 0)
        eln_c = jax.lax.dynamic_slice_in_dim(eln_p, start, chunk, 0)
        cid = eln_c // cs  # (c, 10)
        loc = eln_c % cs
        # (c, 10, 10, 3, 3): [e, i, j, a, b] = esm[e, 3i+a, 3j+b]
        pair = esm_c.reshape(chunk, 10, 3, 10, 3).transpose(0, 1, 3, 2, 4)
        same = cid[:, :, None] == cid[:, None, :]
        row = 3 * loc[:, :, None, None] + a3[None, None, None, :]  # (c,10,1,3)
        key = (cid[:, :, None, None] * m + row) * (m // 3) + loc[:, None, :, None]
        key = jnp.where(same[:, :, :, None], key, nrow)
        acc = acc.at[key.reshape(-1)].add(pair.reshape(-1, 3))
        return acc, None

    acc0 = jnp.zeros((nrow + 1, 3), dtype)
    starts = jnp.arange(nchunks, dtype=jnp.int32) * chunk
    acc, _ = jax.lax.scan(body, acc0, starts)
    blocks = acc[:-1].reshape(ncl, m, m // 3, 3).reshape(ncl, m, m)

    mask = fixmask.reshape(ncl, m)
    mij = mask[:, :, None] * mask[:, None, :]
    eye = jnp.eye(m, dtype=dtype)
    blocks = blocks * mij + eye[None] * (1.0 - mask)[:, :, None]
    # f32 factorization like the coarse path: the result is only a
    # preconditioner
    blocks32 = blocks.astype(jnp.float32)
    chol = jax.vmap(lambda b: jax.scipy.linalg.cho_factor(b, lower=True)[0])(
        blocks32
    )
    inv = jax.vmap(
        lambda c: jax.scipy.linalg.cho_solve(
            (c, True), jnp.eye(m, dtype=jnp.float32)
        )
    )(chol)
    return inv.astype(dtype)
