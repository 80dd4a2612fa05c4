"""Global configuration (the reference's three-tier config system, rebuilt).

The reference reads a one-key ``fcVM.ini`` selecting one of three sparse
Cholesky backends (``source code/fcVM.py:58-71``).  On the device the
backend choice collapses to the matrix-free PCG solver; the remaining knobs
(dtype policy, CG tolerances, preconditioner) live here.  Per-model analysis
parameters stay in the 21-line ``.inp`` control file
(:mod:`fcvm_tpu.models.inp`), mirroring the reference schema.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class FcvmConfig:
    """Framework-level solver configuration.

    Attributes:
      solver: linear solver backend. ``"cg"`` = matrix-free block-Jacobi
        preconditioned conjugate gradients on device (the matrix-free
        replacement for the reference's CHOLMOD/cholespy/sksparse backends,
        ``source code/fcVM.py:66-71``). ``"scipy"`` = host sparse direct
        factorization (debug/validation and the plain reference only).
      dtype: compute dtype for the solve path. ``None`` = float64 when JAX
        x64 is enabled, else float32.
      cg_rtol: relative residual tolerance of the inner CG solve.  The
        outer Newton-Raphson tolerance of the reference is 5e-3 relative
        (typical ``error_max`` in the bundled ``.inp`` corpus), so the
        default keeps the inner solve ~3 orders tighter.
      cg_atol: absolute CG tolerance floor.
      cg_maxiter: CG iteration cap. ``0`` = 10 * sqrt(ndof) heuristic.
      precond: ``"two_level"`` (default; 3x3 nodal blocks + aggregation
        coarse correction with rigid-body modes, see
        :mod:`fcvm_tpu.ops.precond`) or ``"block_jacobi"``.
      coarse_max_clusters: cap on the number of node clusters of the
        two-level coarse space (coarse dim = 6 * clusters; the dense coarse
        inverse is built once on device).
      coarse_cluster_nodes: preferred nodes per cluster before the cap.
      n_eig_vectors: subspace size for the buckling eigensolver (>= 2
        requested modes, larger improves convergence).
      seed_elastic_factorization: retain elastic-stiffness preconditioner
        across Newton iterations for geometric-linear runs (modified NR,
        mirroring the reference's fixed elastic factor,
        ``source code/fcVM.py:1400-1406``).
    """

    solver: str = "cg"
    dtype: Optional[jnp.dtype] = None
    cg_rtol: float = 1.0e-6
    cg_atol: float = 0.0
    cg_maxiter: int = 0
    precond: str = "two_level"
    # Fine-level smoother of the two-level preconditioner: "jacobi3" = 3x3
    # nodal block-Jacobi (default); "cluster" = non-overlapping
    # block-Cholesky over index-contiguous node clusters — ~25% fewer CG
    # iterations, but a costlier batched apply and batched-Cholesky build;
    # it was slower per step on the accelerator the solver was first tuned
    # for.  Which pays on the H100 is an open measurement.
    smoother: str = "jacobi3"
    smoother_cluster_nodes: int = 64
    coarse_max_clusters: int = 1500
    coarse_cluster_nodes: int = 32
    # Cluster mode basis: 12 = affine (rigid + uniform strains; measured
    # 77->44 CG iters at equal cluster size, still fewer at equal coarse
    # dimension), 6 = rigid-body only.
    coarse_modes: int = 12
    # Cap on the dense coarse dimension (modes * clusters).  A larger coarse
    # space cuts CG iterations but the dense factor+inverse
    # (ops.precond.coarse_invert) grows as dim^2 in memory and dim^3 in
    # work; 12288 was sized for a 16 GB device.  The right cap for the
    # H100's 80 GB is an open measurement.
    coarse_max_dim: int = 12288
    n_eig_vectors: int = 8
    seed_elastic_factorization: bool = True
    # Multi-chip: run the full collapse driver SPMD over an n-device
    # jax.sharding.Mesh element partition (fcvm_tpu.parallel.system).
    # 0/1 = single device.  Env: FCVM_NDEVICES.
    n_devices: int = 0
    # Run the sharded SPMD backend even at n_devices <= 1 (a 1-device
    # jax.sharding.Mesh): exercises the shard_map kernels, as the device
    # compiles them, on a single card.  Env: FCVM_FORCE_SHARDED=1.
    force_sharded: bool = False
    # Node-partitioned CG for the sharded backend: the whole PCG loop runs
    # inside shard_map on Morton ROW SLICES of the node vectors (one
    # all_gather in + one psum_scatter out per matvec — same total bytes
    # as the replicated design's single psum), so the preconditioner apply
    # and vector algebra divide by n instead of replicating: the replicated
    # design's Amdahl share grows with the device count.  Default off:
    # replication is simpler and collective-equal; which layout wins on
    # NVLink-joined GPUs is an open measurement.
    # Env: FCVM_NODE_PARTITION=1.
    node_partition: bool = False
    # Ritz-deflation recycling (fcvm_tpu.ops.deflation): one NR correction
    # solve harvests its Lanczos byproducts; the lowest Ritz vectors of
    # M^-1 K deflate every subsequent solve, RETAINED ACROSS LOAD STEPS
    # (re-Galerkined on tangent refresh) until a deflated solve regresses
    # past deflation_refresh_iters.  At 499k dof residual solves dropped
    # 56 -> 40 CG iterations (tools/deflate_step_probe.py).  Harvesting
    # every step instead spends an undeflated harvest solve per step,
    # which ate the savings.  The space must be harvested from a residual
    # rhs — an elastic-rhs harvest does nothing for plastic-residual
    # solves.  On by default for the cg tier, single-device and sharded
    # alike; its wall-time gain on the H100 is an open measurement.
    # Env: FCVM_DEFLATION=0 disables.
    deflation: bool = True
    # Ritz vectors kept per harvest (single pass; a second-pass combined
    # space measured WORSE on fresh rhs — overfit to the harvested one).
    deflation_k: int = 32
    # Harvest buffer length: (nstore, ndof) preconditioned residuals are
    # stored on device during a harvesting solve (nstore * ndof * 4 B in
    # f32).
    deflation_nstore: int = 64
    # Skip the build when the harvest solve converged in fewer iterations:
    # nothing to win, and on small meshes the k-vector correction is pure
    # overhead plus a Newton-convergence hazard (marginally-converged
    # deflated solutions slow modified NR; measured restart spirals).
    deflation_min_iters: int = 48
    # Drop the retained space when a deflated solve needs this many
    # iterations (staleness from plastic-front motion / tangent drift);
    # the next correction solve then re-harvests.  Fresh-space deflated
    # solves run ~30-44 iters at 499k dof, stale ones drift back toward
    # the undeflated 56 — re-harvesting at 48 costs one undeflated solve
    # and restores the ~25% per-solve saving.
    deflation_refresh_iters: int = 48
    # GNL tangent-predictor load-space recycling (the ``lstate`` machinery
    # in runtime/driver.py).  Separate switch from the residual-space
    # recycling above because the predictor is ALSO warm-started from the
    # previous predictor solution, and at 499k dof the warm start alone
    # already reached the deflated iteration count (tools/gnl_refresh_probe.py:
    # cold 88 iters, warm 21, warm + load space 21 — the load space adds
    # re-Galerkin and W traffic and no iterations).  Its cost on the H100
    # is an open measurement.  Env: FCVM_LOAD_DEFLATION=0 disables.
    load_deflation: bool = True
    # The buckling eigensolve re-solves ONE fixed operator for m columns x
    # up to 60 sweeps at rtol <= 1e-10, so its harvest wants to go much
    # deeper than the driver's 64-slot buffer (a 64-step Lanczos prefix of
    # a 1000+-iteration solve holds too weak a low band — measured NET LOSS;
    # 512/64 measured 1.9x on a 20:1 clamped-free column, CPU f64).  The
    # buffer is capped to ~1 GiB at large ndof inside buckling_from_arrays.
    buckling_deflation_nstore: int = 512
    buckling_deflation_k: int = 64
    # Buckling BC treatment: "eliminate" (default) removes fixed dofs
    # exactly (identity rows in K_hat, zero rows in G_hat); "penalty"
    # reproduces the reference's x100 fixed-diagonal penalty on the FULL
    # (uneliminated) pencil (fcVM.py:1051-1062) for exact committed-corpus
    # factor parity — the committed Bar-buckling factors [0.43472, 0.43473]
    # differ from exact elimination by ~3e-4 precisely because of this
    # penalty.  Env: FCVM_BUCKLING_BC.
    buckling_bc: str = "eliminate"
    # Automatic precision governance of the collapse driver (the reference
    # never needs one — its whole pipeline is f64 numpy + CHOLMOD,
    # fcVM.py:1111-1135): when an f32 run's Newton residual stagnates at an
    # arithmetic floor ABOVE error_max, the driver either (a) clamps the
    # effective tolerance to ~2x the measured floor when that stays within
    # a decade of error_max (noise-aware stepping — the restart ladder must
    # not thrash against roundoff), or (b) reruns the whole analysis in the
    # f64 tier when the floor is far above the requested tolerance
    # (runtime/driver.PrecisionFloorError; same pattern as the buckling
    # eigensolve failover).  Env: FCVM_PRECISION_FAILOVER=0 disables.
    precision_failover: bool = True
    # Mixed-precision iterative refinement: the tier BETWEEN the noise
    # clamp and the full-f64 rerun (SURVEY.md "mixed-precision with
    # iterative refinement" as the matrix-free CHOLMOD-f64 equivalent,
    # fcVM.py:1111-1135).  When the f32 Newton residual stagnates at a
    # roundoff-class floor too far above error_max to clamp, the driver
    # switches RESIDUAL EVALUATION to f64 (state upcast inside the jit;
    # exact out-of-balance force of the f32-stored state) and accumulates
    # the Newton increment du in f64, while the operator, preconditioner
    # and CG correction solves stay f32.  The refined Newton loop then
    # converges to the true error_max instead of rerunning the whole
    # analysis in f64 (the rerun remains the final tier if even refined
    # residuals stagnate).
    # Env: FCVM_RESIDUAL_REFINEMENT=0 disables.
    residual_refinement: bool = True
    # CG-operator einsum precision (ops/assembly.resolve_matvec_precision):
    # an accelerator's default f32 einsum may run in reduced precision
    # (bf16 passes; TF32 on a GPU) whose ~1e-3-class noise bounds what the
    # Newton loop can reach through the correction solves — it left the
    # Embankment replay (81k dof, error_max 1e-2) diverging where CPU f32
    # converges every step.  "auto" = full f32 precision below
    # matvec_hp_max_dof, the device default above (the threshold was a
    # cost trade on the first accelerator; what the default does on the H100 is
    # recorded in PERF.md); "highest" / "default" force.  Resolved at trace
    # time from the static operator size. Env: FCVM_MATVEC_PRECISION,
    # FCVM_MATVEC_HP_MAX_DOF.
    matvec_precision: str = "auto"
    matvec_hp_max_dof: int = 200_000
    # Element-block formation / geometry einsum precision
    # (ops/assembly.formation_precision): "highest" (default — a
    # reduced-precision f32 default leaves the formed operator
    # inconsistent with the full-precision internal-force route at ~1e-2
    # on badly-scaled meshes; it diverged the Embankment f32 replay) or
    # "default" for A/B measurement.  Env: FCVM_FORMATION_PRECISION.
    formation_precision: str = "highest"
    # Background AOT prewarm of the two-level preconditioner executables
    # (runtime/prewarm.py): a fresh process's FIRST build waits on compiling
    # (or loading from the persistent cache) its executables; a daemon
    # thread AOT-compiles them from shape structs (no device memory) so
    # that work overlaps host setup and the first assembly.  Whether it
    # still pays on the H100 is an open measurement.
    # Env: FCVM_PREWARM=0 disables.
    prewarm: bool = True
    # Fused Newton iteration (SURVEY.md build-plan step 6): each steady
    # NR iteration — optional GNL tangent refresh (a static variant), the
    # correction CG solve, the Riks update and the stress-update/residual
    # — runs as ONE device program, with a single bundled scalar fetch
    # per iteration for host governance (runtime/system.newton_iteration,
    # parallel/system.newton_fn).  The unfused path (6 dispatches + 3
    # blocking fetches per iteration) remains for the scipy tier,
    # deflation-harvest iterations and the f64 refinement mode, and as a
    # debug/A-B switch here.  It removes per-call dispatch overhead, which
    # weighs most on the sharded backend.  Env: FCVM_FUSED_NEWTON=0
    # disables.
    fused_newton: bool = True
    # Arc-length control of the nonlinear driver: "riks" = the reference's
    # linearized load correction + norm scale-back (fcVM.py:1414-1434;
    # parity default — stalls at snapback folds, where the scale-back
    # never lets |du| grow within a step).  "crisfield" = spherical
    # constraint solved exactly per iteration (quadratic root chosen by
    # path continuity) — traverses snap-through AND snapback
    # (runtime/system.riks_update_crisfield).  Env: FCVM_ARC.
    arc_length: str = "riks"

    def resolve_cluster_size(self, nn: int) -> int:
        """Nodes per cluster for the two-level coarse space.

        Sized so the dense coarse dimension (coarse_modes * clusters) stays
        within ``coarse_max_dim`` — the affine basis halves the affordable
        cluster count but still nets fewer iterations at equal dimension.
        """
        ncl_cap = max(1, min(self.coarse_max_clusters,
                             self.coarse_max_dim // max(self.coarse_modes, 1)))
        cs = max(self.coarse_cluster_nodes, -(-nn // ncl_cap))
        return min(cs, max(nn // 2, 1))

    def resolve_dtype(self):
        if self.dtype is not None:
            return jnp.dtype(self.dtype)
        if jax.config.read("jax_enable_x64"):
            return jnp.dtype(jnp.float64)
        return jnp.dtype(jnp.float32)

    def resolve_cg_maxiter(self, ndof: int) -> int:
        """Safety cap only — the rtol criterion does the stopping.

        CG converges in <= ndof steps in exact arithmetic; slender
        bending-dominated meshes genuinely need O(ndof) iterations under
        block-Jacobi, so the cap must not truncate them.
        """
        if self.cg_maxiter > 0:
            return self.cg_maxiter
        return min(max(1000, 2 * ndof), 200_000)


_config = FcvmConfig()

if os.environ.get("FCVM_SOLVER"):
    _config.solver = os.environ["FCVM_SOLVER"]
if os.environ.get("FCVM_NDEVICES"):
    _config.n_devices = int(os.environ["FCVM_NDEVICES"])
if os.environ.get("FCVM_CG_RTOL"):
    _config.cg_rtol = float(os.environ["FCVM_CG_RTOL"])
if os.environ.get("FCVM_DEFLATION"):
    _config.deflation = os.environ["FCVM_DEFLATION"] not in ("0", "off", "false")
if os.environ.get("FCVM_LOAD_DEFLATION"):
    _config.load_deflation = os.environ["FCVM_LOAD_DEFLATION"] not in (
        "0", "off", "false"
    )
if os.environ.get("FCVM_FUSED_NEWTON"):
    _config.fused_newton = os.environ["FCVM_FUSED_NEWTON"] not in (
        "0", "off", "false"
    )
if os.environ.get("FCVM_ARC"):
    _config.arc_length = os.environ["FCVM_ARC"]
if os.environ.get("FCVM_BUCKLING_BC"):
    _config.buckling_bc = os.environ["FCVM_BUCKLING_BC"]
if os.environ.get("FCVM_FORCE_SHARDED"):
    _config.force_sharded = os.environ["FCVM_FORCE_SHARDED"] not in (
        "0", "off", "false"
    )
if os.environ.get("FCVM_NODE_PARTITION"):
    _config.node_partition = os.environ["FCVM_NODE_PARTITION"] not in (
        "0", "off", "false"
    )
if os.environ.get("FCVM_MATVEC_PRECISION"):
    _config.matvec_precision = os.environ["FCVM_MATVEC_PRECISION"]
if os.environ.get("FCVM_FORMATION_PRECISION"):
    _config.formation_precision = os.environ["FCVM_FORMATION_PRECISION"]
if os.environ.get("FCVM_MATVEC_HP_MAX_DOF"):
    _config.matvec_hp_max_dof = int(os.environ["FCVM_MATVEC_HP_MAX_DOF"])
if os.environ.get("FCVM_PREWARM"):
    _config.prewarm = os.environ["FCVM_PREWARM"] not in ("0", "off", "false")
if os.environ.get("FCVM_PRECISION_FAILOVER"):
    _config.precision_failover = os.environ["FCVM_PRECISION_FAILOVER"] not in (
        "0", "off", "false"
    )
if os.environ.get("FCVM_RESIDUAL_REFINEMENT"):
    _config.residual_refinement = os.environ["FCVM_RESIDUAL_REFINEMENT"] not in (
        "0", "off", "false"
    )
if os.environ.get("FCVM_DTYPE"):
    # Precision tier: FCVM_DTYPE=float64 runs the whole solve in f64, which
    # the H100 runs natively (the dense coarse Cholesky stays f32,
    # fcvm_tpu.ops.precond).  This is the corpus-parity tier; f32 is the
    # production tier, whose residual floor is ~2e-7 relative.
    _dt = os.environ["FCVM_DTYPE"].lower()
    _config.dtype = {"f32": "float32", "f64": "float64"}.get(_dt, _dt)
    if _config.dtype == "float64":
        jax.config.update("jax_enable_x64", True)


# Default persistent compile cache: a fixed directory at the checkout root
# (a path that changed between processes — a temp name, a pid, the time —
# would never be found again).
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache for this process.

    The analysis kernels (assembly, Galerkin coarse build, CG composites)
    take seconds to minutes each to compile cold; the persistent cache
    removes that cost for every later process on the same machine.  Called
    automatically at analysis entry; set ``FCVM_NO_COMPILE_CACHE=1`` to opt
    out (e.g. for compile-time benchmarking).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
    there and nothing is set in code.  Otherwise the cache goes to
    :data:`DEFAULT_COMPILE_CACHE_DIR` (``.jax_cache/`` at the checkout
    root).  Returns the directory in use ("" when opted out).
    """
    if os.environ.get("FCVM_NO_COMPILE_CACHE"):
        return ""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    cache_dir = DEFAULT_COMPILE_CACHE_DIR
    if jax.config.jax_compilation_cache_dir != cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        # 0.0: persist even sub-second compiles (the coarse inverse's small
        # eager helpers would otherwise recompile in every process)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir


def get_config() -> FcvmConfig:
    return _config


def set_config(cfg: FcvmConfig) -> None:
    global _config
    _config = cfg
