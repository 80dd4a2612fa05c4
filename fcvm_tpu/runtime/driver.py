"""Incremental-iterative collapse driver: Riks arc-length + restarts.

Matrix-free rebuild of ``calcDisp`` (``source code/fcVM.py:1083-1635``), the
heart of the reference.  The hot work — stress updates, CG solves, tangent
reassembly, Riks corrections — runs on device inside the jitted composites of
:mod:`fcvm_tpu.runtime.system`; the host keeps only the cheap per-step
control flow the reference also keeps in Python: load stepping, divergence
restarts with shrinking increments (4-restart cap, ``fcVM.py:1457-1484``),
adaptive step scaling (``fcVM.py:1530-1537``), target-load-factor
interception (``fcVM.py:1486-1510``) and history recording.

Intentional divergences from the reference (documented):

* ``un`` (the displacement history) takes the max nodal displacement norm
  over *all* nodes; the reference's list comprehension at ``fcVM.py:1494``
  drops the last node (``range((ndof - 1) // 3)``).
* The singular-matrix try/except around the factorization
  (``fcVM.py:1367-1381``) maps to the CG iteration cap: a non-converged CG
  solve plays the role of a failed factorization and triggers the same
  divergence-restart path.
* The interactive matplotlib continuation loop (``fcVM.py:1638-2080``) is a
  programmatic ``continuation`` callback (stop / add steps / reverse /
  retarget) plus on-disk checkpointing, since batch runs have no GUI.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fcvm_tpu.config import get_config
from fcvm_tpu.models.inp import ControlParams
from fcvm_tpu.models.spec import Model
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.runtime.profiling import PhaseTimers
from fcvm_tpu.utils.indexing import pad_vector


@dataclasses.dataclass
class History:
    """Per-converged-step records (the reference's plot lists,
    ``fcVM.py:1184-1193``)."""

    un: list = dataclasses.field(default_factory=lambda: [0.0])
    load: list = dataclasses.field(default_factory=lambda: [0.0])
    crip: list = dataclasses.field(default_factory=lambda: [0])
    peeq: list = dataclasses.field(default_factory=lambda: [0.0])
    pressure: list = dataclasses.field(default_factory=lambda: [0.0])
    svm: list = dataclasses.field(default_factory=lambda: [0.0])
    triax: list = dataclasses.field(default_factory=lambda: [0.0])
    ecr: list = dataclasses.field(default_factory=lambda: [0.0])
    csr: list = dataclasses.field(default_factory=lambda: [0.0])
    peeqmax: list = dataclasses.field(default_factory=lambda: [0.0])
    lbd: list = dataclasses.field(default_factory=lambda: [0.0])

    def truncate(self, n: int):
        for f in dataclasses.fields(self):
            lst = getattr(self, f.name)
            del lst[n:]

    def limits(self, ultimate_strain: float, use_csr: bool):
        """(elastic limit index, ultimate limit index)
        (``fcVM.py:1595-1612``)."""
        csr = np.asarray(self.csr)
        nz = np.nonzero(csr)[0]
        el_limit = int(nz[0] - 1) if len(nz) else 0
        if use_csr:
            over = np.argwhere(csr > 1.0)
        else:
            over = np.argwhere(np.asarray(self.peeqmax) > ultimate_strain)
        ul_limit = int(over[0][0] - 1) if len(over) else 0
        return el_limit, ul_limit


@dataclasses.dataclass
class AnalysisResults:
    """Everything ``calcDisp`` returns, plus solver statistics."""

    disp: np.ndarray  # requested output (total or incremental)
    disp_total: np.ndarray
    disp_el: np.ndarray
    eigenvalues: Optional[np.ndarray]
    eigenvectors: Optional[np.ndarray]
    sig_gp: np.ndarray  # (ne, 4, 6)
    peeq_gp: np.ndarray  # (ne, 4)
    csr_gp: np.ndarray
    svm_gp: np.ndarray
    triax_gp: np.ndarray
    sig_yield_gp: np.ndarray
    history: History
    gp_coords: np.ndarray  # (ne, 4, 3)
    volume: float
    loadsums: np.ndarray
    fail: bool
    coords_old: np.ndarray  # pre-imperfection coordinates
    coords: np.ndarray  # coordinates used in the solve (post-imperfection)
    timers: dict
    cg_stats: dict
    # displacement output scale from the continuation loop's ("scale", v)
    # action (the reference's ds TextBox, fcVM.py:1657,1689,1948); consumed
    # by the deformed-geometry viewers in runtime.viz
    disp_scale: float = 1.0


class PrecisionFloorError(RuntimeError):
    """The f32 Newton residual stagnated at an arithmetic floor above
    ``error_max`` that is too far above the requested tolerance to clamp.

    The reference has no such failure mode — its entire pipeline is f64
    numpy + CHOLMOD (``fcVM.py:1111-1135``).  :func:`solve_collapse`
    catches this and reruns the analysis in the f64 tier automatically
    (``config.precision_failover``), the same pattern as the buckling
    eigensolve's :class:`fcvm_tpu.runtime.buckling.EigensolveBreakdownError`
    failover."""


# f32 residual-floor detector tuning (see _FloorWatch).  The measured f32
# floor is ~2e-7 relative with full-precision stress-update einsums
# (PARITY.md precision budget); slender near-buckling tangents can creep
# an order or two higher before stalling.
_FLOOR_WINDOW = 4  # iterations of non-improvement that define "stagnant"
_FLOOR_IMPROVE = 0.7  # stagnant = best error improved < 30% over the window
_FLOOR_CLAMP_FACTOR = 10.0  # clamp only while 2*floor <= 10 * error_max
_FLOOR_ESCALATE_CAP = 1.0e-3  # escalate only below this absolute error —
# a stagnation ABOVE it is physics (limit-load imbalance), not roundoff,
# and f64 would stall the same way
_FLOOR_RISE = 1.03  # rising-tail veto: an error sitting on an arithmetic
# floor BOUNCES around its level (it keeps returning to within a few % of
# the window best), while a diverging Newton attempt CLIMBS away from it.
# Clamp/escalate fire only when one of the last TWO errors is within 3%
# of the window best; a tail that stays above is divergence in progress
# and must go to the restart ladder, not be clamp-accepted.  (Found on
# hardware: the Embankment f32 replay's steps 3-4 climbed 1.55e-2 ->
# 1.72e-2 / 3.97e-2 -> 5.23e-2 inside the decade window and were wrongly
# accepted, poisoning the run to an early end at LF 0.233 vs 0.4997
# without governance; the 1.62e-2 mid-climb reading sits 4.5% above the
# window best, so the veto band must be tighter than that.)


class _FloorWatch:
    """Detect the f32 residual floor in a Newton error sequence.

    Genuine Newton/modified-NR convergence contracts the error at least
    geometrically; a sequence whose best error improves by less than 30%
    over 4 consecutive iterations while still above ``error_max`` is
    sitting on an arithmetic floor (or a physical limit state — the
    absolute level tells them apart, see ``_FLOOR_ESCALATE_CAP``).

    ``observe(error)`` returns ``None`` (keep iterating), ``("clamp", e)``
    (accept convergence at the noise-clamped tolerance ``e``), or
    ``"escalate"`` (the floor is too far above ``error_max`` — rerun in
    f64).  ``reset(attempt)`` starts a fresh step attempt (each restart
    re-probes: smaller increments lower the floor with the residual
    magnitudes).

    Clamp/escalate fire only from the SECOND attempt of a step on
    (``attempt >= 1``): the restart ladder's step-shrink is a free second
    opinion — a genuinely diverging attempt usually converges after the
    shrink (the reference's only mechanism, ``fcVM.py:1457-1484``), while
    an arithmetic floor stagnates again at the same level.  (Found on
    hardware: Embankment f32's first-attempt stagnations were clamp-
    accepted mid-divergence and poisoned the run, LF 0.233 vs 0.4997.)
    Once a clamp HAS fired (the run is proven floor-limited at this
    ``error_max``), later steps may clamp on their first attempt — a
    floored plateau then doesn't pay one restart per step.
    """

    def __init__(self, error_max: float, enabled: bool):
        self.error_max = error_max
        self.enabled = enabled
        self.errs: list = []
        self.attempt = 0
        self.run_floored = False  # a clamp fired earlier in this run

    def reset(self, attempt: int = 0):
        self.errs = []
        self.attempt = attempt

    def observe(self, error: float):
        if not self.enabled:
            return None
        self.errs.append(error)
        if len(self.errs) <= _FLOOR_WINDOW:
            return None
        best_now = min(self.errs[-_FLOOR_WINDOW:])
        best_before = min(self.errs[:-_FLOOR_WINDOW])
        if best_now <= _FLOOR_IMPROVE * best_before:
            return None  # still converging
        if best_now <= self.error_max:
            return None  # the exit criterion will fire on its own
        if min(self.errs[-2:]) > _FLOOR_RISE * best_now:
            return None  # rising tail: divergence, not a floor (see above)
        if self.attempt < 1 and not self.run_floored:
            return None  # first attempt: let the restart re-probe once
        if 2.0 * best_now <= _FLOOR_CLAMP_FACTOR * self.error_max:
            self.run_floored = True
            return ("clamp", 2.0 * best_now)
        if best_now <= _FLOOR_ESCALATE_CAP:
            return "escalate"
        return None  # physical stagnation — leave it to the restart ladder

    def escalate_at_mrr(self) -> bool:
        """Restarts exhausted: escalate iff the abandoned attempt's best
        error was small (roundoff-class, below the escalate cap) yet above
        ``error_max`` — the step was *almost* converged and f64 would
        finish it.  Large best errors mean genuine divergence (the normal
        end of a collapse analysis) and must NOT trigger a rerun."""
        if not self.enabled or not self.errs:
            return False
        best = min(self.errs)
        return self.error_max < best <= _FLOOR_ESCALATE_CAP


class _LinearState:
    """Current linear operator: blocks + preconditioner (the CG budget
    lives on the backend — ``backend.rtol``/``backend.maxiter``).

    With ``config.solver == "scipy"`` a host LU factorization is built
    lazily per operator state — the debugging tier mirroring the reference's
    factor-once-per-tangent Cholesky (``fcVM.py:1120-1135``)."""

    def __init__(self, esm, pc, defl=None):
        self.esm = esm
        self.pc = pc
        self.defl = defl  # Ritz recycling space (ops.deflation), if built
        self._direct = None

    def direct(self, backend):
        if self._direct is None:
            self._direct = backend.scipy_direct(self.esm)
        return self._direct


def solve_collapse(
    model: Model,
    params: ControlParams,
    continuation: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    progress: Optional[Callable[[str], None]] = None,
    monitor: Optional[Callable] = None,
) -> AnalysisResults:
    """Run a full collapse analysis with automatic precision governance.

    Thin wrapper over :func:`_solve_collapse_impl` (the actual driver; see
    its docstring for the argument semantics): when an f32 run raises
    :class:`PrecisionFloorError` — the Newton residual stagnated at the f32
    arithmetic floor far above ``error_max`` — the whole analysis reruns in
    the f64 tier, matching the reference's unconditionally-f64 pipeline
    (``fcVM.py:1111-1135``).  The x64 flag and config dtype are restored
    afterwards so later f32 analyses in the same process stay 32-bit.

    Note: progress/monitor/continuation callbacks fire again during the
    rerun, and checkpoints (if any) are overwritten from step 0.
    """
    import warnings

    cfg = get_config()
    # The refinement tier (config.residual_refinement) may enable x64
    # mid-run for its f64 residual jits; restore the process default on
    # every exit path so later f32 analyses keep their f32-keyed traces.
    x64_at_entry = jax.config.read("jax_enable_x64")
    try:
        return _solve_collapse_wrapped(
            model, params, continuation, checkpoint_path, resume_from,
            progress, monitor, cfg,
        )
    finally:
        if jax.config.read("jax_enable_x64") != x64_at_entry:
            jax.config.update("jax_enable_x64", x64_at_entry)


def _solve_collapse_wrapped(
    model, params, continuation, checkpoint_path, resume_from, progress,
    monitor, cfg,
):
    import warnings

    try:
        return _solve_collapse_impl(
            model, params, continuation, checkpoint_path, resume_from,
            progress, monitor,
        )
    except PrecisionFloorError as err:
        if not cfg.precision_failover or cfg.resolve_dtype() != jnp.float32:
            raise
        msg = (f"f32 collapse run hit its residual floor ({err}); "
               "rerunning the analysis in the float64 tier")
        warnings.warn(msg)
        if progress is not None:
            progress(f"PRECISION FAILOVER: {msg}")
        prev_dtype = cfg.dtype  # restore verbatim (None stays None:
        # resolve_dtype() re-derives f32 once x64 is restored below)
        x64_prev = jax.config.read("jax_enable_x64")
        jax.config.update("jax_enable_x64", True)
        cfg.dtype = "float64"
        try:
            # AnalysisResults holds only host numpy arrays, so all f64
            # device work completes before the flags are restored.
            # resume_from=None: the rerun must NOT resume from the f32
            # run's own checkpoints — steps 0..k would stay floor-quality
            # f32 state in the "f64" result (the docstring promises the
            # checkpoints are overwritten from step 0).
            res = _solve_collapse_impl(
                model, params, continuation, checkpoint_path, None,
                progress, monitor,
            )
            res.cg_stats["f64_reruns"] = 1
            return res
        finally:
            cfg.dtype = prev_dtype
            if not x64_prev:
                jax.config.update("jax_enable_x64", False)


def _solve_collapse_impl(
    model: Model,
    params: ControlParams,
    continuation: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    progress: Optional[Callable[[str], None]] = None,
    monitor: Optional[Callable] = None,
) -> AnalysisResults:
    """Run a full collapse analysis (the Start-button pipeline, GUI-free).

    Args:
      model: mesh + material + BCs + loads.
      params: the 21 control parameters.
      continuation: optional callback ``(history, state_info) -> action``
        where action is ``None``/``"stop"``, ``"add"`` (run ``nstep`` more
        steps), ``"rev"`` (reverse loading), ``("target", new_target_lf)``,
        ``("scale", disp_scale)`` (displacement-output scale for the
        deformed-geometry viewers, the reference's ``ds`` box,
        ``fcVM.py:1657,1689``), or a list/tuple of those applied in order
        (e.g. ``[("scale", 20.0), "add"]``); unrecognized actions raise.
        Mirrors the reference's interactive plot loop (``fcVM.py:2004-2080``).
      checkpoint_path: if set, converged-step state is saved there
        (``fcvm_tpu.runtime.checkpoint``).
      progress: optional line logger (the reference's ``prn_upd``).
      monitor: optional per-converged-step observer
        ``(disp_nodes, history) -> None`` receiving the (nn, 3) total
        nodal displacements already fetched for the history record —
        track arbitrary dofs (e.g. a snapback monitor point) without
        checkpointing.  Beyond-reference: the GUI showed this visually.

    Returns:
      :class:`AnalysisResults`.
    """
    cfg = get_config()
    from fcvm_tpu.config import enable_compilation_cache

    enable_compilation_cache()  # compile once per kernel, ever (see config)
    import os as _os

    nr_trace = bool(_os.environ.get("FCVM_NR_TRACE"))  # per-bracket timing
    model.mesh.validate()  # fail fast, not deep inside a jit
    dtype = cfg.resolve_dtype()
    log = progress or (lambda s: None)
    timers = PhaseTimers()
    if checkpoint_path and jax.process_index() != 0:
        # multi-host SPMD: every process computes identical state; only
        # process 0 touches the checkpoint directory
        checkpoint_path = None

    large_disp = params.large_disp
    relax = 1.0 if large_disp else params.relax
    disp_output = "total" if large_disp else params.disp_output
    scale_up = 1.1 if large_disp else params.scale_up  # fcVM.py:1087-1094
    nstep = params.nstep

    mesh = model.mesh
    ndof = mesh.ndof
    coords_np = mesh.coords.copy()
    coords_old = mesh.coords.copy()

    from fcvm_tpu.runtime.backend import make_backend

    backend = make_backend(model, cfg, dtype)
    if cfg.solver == "scipy" and not backend.supports_scipy:
        raise ValueError("the scipy direct tier is single-device only")
    et_e = jnp.asarray(params.et_e, dtype=dtype)
    ndof_pad = backend.ndof_pad
    fixmask = backend.fixmask
    u_fix = backend.u_fix
    movdof = backend.movdof
    has_movdof = backend.has_movdof

    cg_stats = {"solves": 0, "iters": 0, "time": 0.0, "tangent_time": 0.0,
                "predictor_solves": 0, "predictor_iters": 0,
                "deferred_solves": 0,
                # coarse-build degradation counters (ops.precond ladder):
                # a zero-coarse fallback costs 4-7x CG iterations, so it
                # must be loud in the run log, not just a Python warning
                "coarse_ridge_escalations": 0, "coarse_zero_fallbacks": 0,
                # noise-aware stepping: steps accepted at a tolerance
                # clamped to ~2x the measured f32 residual floor
                "floor_clamps": 0, "floor_clamp_steps": [],
                # mixed-precision refinement (the tier between clamp and
                # the f64 rerun): activation count + first refined step
                "refinement_activations": 0, "refined_from_step": None,
                # driver-issued device-program launches (dispatch-latency
                # telemetry: each one pays per-call launch overhead — the
                # quantity the fused Newton iteration minimizes); logged
                # per converged step at end of run
                "dispatches": 0,
                # NR iterations that ran as ONE fused device program
                # (runtime/system.newton_iteration)
                "fused_iterations": 0,
                # HP-matvec escalation (reduced-precision CG-correction
                # noise above
                # matvec_hp_max_dof): activation count + first step
                "hp_matvec_activations": 0, "hp_from_step": None,
                # 1 when this result comes from the automatic f64 rerun
                # of an f32 run that hit its residual floor
                "f64_reruns": 0}

    def disp_count(n: int = 1):
        cg_stats["dispatches"] += n
    # f32 precision governance (see _FloorWatch / PrecisionFloorError)
    floor_watch = _FloorWatch(
        params.error_max,
        enabled=cfg.precision_failover and dtype == jnp.dtype(jnp.float32),
    )
    # Mixed-precision iterative-refinement tier (config.residual_refinement;
    # SURVEY.md's CHOLMOD-f64 equivalent): on a roundoff-class escalation,
    # switch residual EVALUATION to f64 over the f32-stored state and hold
    # du (and, after the first refined commit, disp_new) in f64, keeping
    # the operator/preconditioner/CG f32.  The f64 state is confined to
    # the residual path by trace-time dtype guards at the tangent /
    # internal-force jit boundaries.  The full-f64 rerun remains the last
    # tier if even refined residuals stagnate.
    refined = False
    refine_ok = (
        cfg.residual_refinement
        and floor_watch.enabled
        and hasattr(backend, "residual_refined")
    )
    # HP-matvec escalation: the tier BELOW refinement.  Above
    # matvec_hp_max_dof the production CG matvec keeps the device's default
    # f32 precision (ops/assembly.resolve_matvec_precision); where that is
    # reduced precision, on a struggling step the ~1e-3-class correction
    # noise can stall Newton above
    # error_max and send it into the restart ladder (the reference never
    # restarts on roundoff — its CHOLMOD corrections are exact f64,
    # fcVM.py:1457-1484).  When an f32 attempt stagnates in the roundoff
    # class, escalate the matvec einsum to full f32 precision (HIGHEST) for
    # the remaining solves instead of paying a restart.  Sticky for the
    # rest of the run: re-probing the fast path each step would pay a
    # ~5-iteration stall per step to save a fraction of each iteration.
    hp_mode = False
    hp_available = (
        floor_watch.enabled
        and cfg.solver == "cg"
        and cfg.matvec_precision == "auto"
        and backend.ndof_pad > cfg.matvec_hp_max_dof
    )

    def try_hp(where: str) -> bool:
        nonlocal hp_mode
        if not hp_available or hp_mode:
            return False
        hp_mode = True
        cg_stats["hp_matvec_activations"] += 1
        if cg_stats["hp_from_step"] is None:
            cg_stats["hp_from_step"] = step
        floor_watch.reset(attempt=floor_watch.attempt)
        log(
            f"f32 CG-CORRECTION FLOOR {where}: escalating the CG matvec to "
            "full f32 precision for the remaining solves (reduced-"
            "precision correction noise above matvec_hp_max_dof; "
            "config.matvec_precision)"
        )
        return True

    def activate_refinement(where: str):
        nonlocal refined, du, eff_error_max
        # f64 inside jits needs the x64 flag; restored at function exit
        # (see the finally around the stepping phase)
        jax.config.update("jax_enable_x64", True)
        refined = True
        du = du.astype(jnp.float64)
        eff_error_max = params.error_max  # a refined run resolves the
        # true tolerance — drop any noise clamp
        cg_stats["refinement_activations"] += 1
        if cg_stats["refined_from_step"] is None:
            cg_stats["refined_from_step"] = step
        floor_watch.reset(attempt=floor_watch.attempt)
        log(
            f"f32 RESIDUAL FLOOR {where}: switching to f64 residual "
            "refinement (operator and CG stay f32; "
            "config.residual_refinement)"
        )

    def assemble(coords):
        with timers.phase("assemble"):
            disp_count()
            return backend.assemble(coords)

    def _solve_policy(lin: _LinearState, iters: int):
        # "Stale" is judged against BOTH the absolute threshold and the
        # harvest solve's own iteration count: on hard problems whose
        # baseline solves sit far above deflation_refresh_iters (slender
        # f32 columns: harvest 163, deflated 157), an absolute-only test
        # drops the space after every deflated solve and every second
        # solve becomes a fresh harvest — pure thrash.  At the bench
        # scale (harvest 56, deflated 30-44 < 48) this is identical to
        # the absolute test.
        stale_at = max(cfg.deflation_refresh_iters,
                       defl_state.get("harvest_iters", 0))
        if lin.defl is not None and iters >= stale_at:
            # plastic-front motion / tangent drift made the retained Ritz
            # space stale — drop it so the next correction solve
            # re-harvests from the current residual
            lin.defl = None
            log(f"deflation space stale ({iters} iters), will re-harvest")
        elif lin.defl is None and iters >= cfg.deflation_min_iters:
            # solves got long enough for recycling to pay — re-arm the
            # harvest (hysteresis: a below-threshold harvest disarms it so
            # easy solves don't pay the harvest fetch every iteration)
            defl_state["armed"] = True

    def solve(lin: _LinearState, b, x0=None, defer=False):
        """Linear solve; ``defer=True`` returns ``(x, settle)`` without a
        device sync.

        A synchronous ``block_until_ready`` here leaves the device idle for
        1-2 host round-trips before the caller dispatches the Riks update +
        residual that consume ``x`` — at 28k dof that idle time outweighed
        the step itself.  The NR loop instead defers: it dispatches the
        dependent work immediately and calls ``settle()`` at its own mandatory
        convergence sync, where the solve's iteration count is already on host
        (the D2H copy started below) and the recycling policy acts with
        identical effect (it only ever influences the NEXT solve). Deferred
        solves' ``cg_stats["time"]`` spans until settle, i.e. includes the
        pipelined Riks+residual — see the end-of-run log.
        """
        t0 = time.perf_counter()
        if cfg.solver == "scipy":
            x = jnp.asarray(
                np.asarray(lin.direct(backend).solve(b)), dtype=dtype
            )
            cg_stats["solves"] += 1
            cg_stats["time"] += time.perf_counter() - t0
            return x, (lambda: None) if defer else 0.0
        disp_count()
        res = backend.solve(lin.esm, lin.pc, b, x0=x0, defl=lin.defl,
                            hp=hp_mode)
        # start the scalar D2H transfers before the completion sync so they
        # ride along with it instead of costing an extra host round-trip
        # each
        res.iters.copy_to_host_async()

        def settle():
            iters = int(res.iters)
            cg_stats["solves"] += 1
            cg_stats["iters"] += iters
            cg_stats["time"] += time.perf_counter() - t0
            if defer:
                cg_stats["deferred_solves"] += 1
            _solve_policy(lin, iters)

        if defer:
            return res.x, settle
        x = res.x.block_until_ready()
        settle()
        return x, float(res.relres)

    use_deflation = (
        cfg.deflation
        and cfg.solver == "cg"
        and getattr(backend, "supports_deflation", False)
    )
    # predictor load-space recycling: separately switchable (the warm start
    # already covers the predictor — see config.load_deflation)
    use_ldefl = use_deflation and cfg.load_deflation
    # arc-length flavor: reference-faithful linearized Riks (default) or
    # the spherical Crisfield constraint (traverses snapback folds)
    use_crisfield = cfg.arc_length == "crisfield"
    riks_fn = (sysm.riks_update_crisfield if use_crisfield
               else sysm.riks_update)
    # fused Newton iteration (one dispatch + one scalar fetch per NR
    # iteration; config.fused_newton, SURVEY.md build-plan step 6) —
    # per-iteration routing also excludes harvest/refinement iterations
    fused_ok = (
        cfg.fused_newton
        and cfg.solver != "scipy"
        and getattr(backend, "supports_fused_newton", False)
    )
    # armed=True: the next correction solve without a held space harvests.
    # A harvest below deflation_min_iters disarms (easy solves — nothing to
    # win); a plain solve at or past min_iters re-arms (see solve()).
    defl_state = {"armed": True}
    # The GNL tangent-predictor's own recycling state: a LOAD-rhs-harvested
    # Ritz basis (solve-space (ndof, k)), re-Galerkined against each fresh
    # tangent inside tangent_refresh; same hysteresis as the residual space.
    lstate = {"w": None, "armed": True}

    def harvesting_solve(lin, b):
        """NR correction solve that (re)builds the deflation space from its
        own Lanczos byproducts (``fcvm_tpu.ops.deflation``).  Runs whenever
        no space is held; the space is then RETAINED across load steps
        (re-Galerkined on tangent refresh) until :func:`solve` detects it
        stale.  At 499k dof deflated residual solves run 40 vs 56 iters —
        but a per-step re-harvest pays a 56-iter undeflated solve each
        step, which ate the savings; amortizing one harvest over many
        steps is what makes recycling win.  The space must come from a
        residual rhs — an elastic-rhs harvest does nothing for
        plastic-residual solves (measured: 56 -> 57 iters; see
        tools/deflate_step_probe.py).
        Solves shorter than ``deflation_min_iters`` skip the build: there
        is not enough to win and the k-vector correction would be pure
        per-iteration overhead (and, measured on small meshes, a
        Newton-convergence hazard from marginally-converged solutions)."""
        t0 = time.perf_counter()
        disp_count()
        res, h = backend.solve_harvest(lin.esm, lin.pc, b,
                                       nstore=cfg.deflation_nstore,
                                       hp=hp_mode)
        for arr in (res.iters, res.relres, h.alphas, h.betas, h.rzs):
            arr.copy_to_host_async()  # overlap D2H with the completion sync
        x = res.x.block_until_ready()
        # ONE bundled host fetch (per-array fetches cost a host
        # round-trip each); the fused build below stays async on device
        iters_h, relres_h, alphas, betas, rzs = jax.device_get(
            (res.iters, res.relres, h.alphas, h.betas, h.rzs)
        )
        cg_stats["solves"] += 1
        cg_stats["iters"] += int(iters_h)
        lin.defl = None
        defl_state["harvest_iters"] = int(iters_h)  # staleness reference
        if int(iters_h) < cfg.deflation_min_iters:
            defl_state["armed"] = False
        else:
            from fcvm_tpu.ops import deflation as defl_ops

            coef = defl_ops.ritz_coefficients(
                alphas, betas, rzs, int(iters_h), cfg.deflation_k
            )
            if coef is not None:
                disp_count()
                lin.defl = backend.build_deflation(lin.esm, h.zs, coef)
                kept = int((np.abs(coef).sum(axis=0) > 0).sum())
                log(f"deflation space: k={kept} "
                    f"(harvest solve: {int(iters_h)} iters)")
        cg_stats["time"] += time.perf_counter() - t0
        return x, float(relres_h)

    def make_pc(esm, pinv, coords_dev):
        from fcvm_tpu.ops.precond import COARSE_BUILD_STATS as cbs

        before = (cbs["ridge_escalations"], cbs["zero_coarse_fallbacks"])
        if cfg.precond == "two_level":
            with timers.phase("precond_build"):
                pc = backend.make_pc(esm, pinv, coords_dev)
        else:
            pc = backend.make_pc(esm, pinv, coords_dev)
        esc = cbs["ridge_escalations"] - before[0]
        fb = cbs["zero_coarse_fallbacks"] - before[1]
        cg_stats["coarse_ridge_escalations"] += esc
        cg_stats["coarse_zero_fallbacks"] += fb
        if fb:
            log(
                "WARNING: two-level coarse inverse non-finite at every "
                "ridge — continuing with the fine-level smoother ONLY "
                "(expect a 4-7x CG-iteration regression)"
            )
        elif esc:
            log(
                "two-level coarse build needed "
                f"{cbs['last_escalations']} ridge escalation(s)"
            )
        return pc

    coords = jnp.asarray(coords_np, dtype=dtype)
    esm, pinv, glv, rhs, gp_coords, volume, loadsums = assemble(coords_np)
    lin = _LinearState(esm, make_pc(esm, pinv, coords))

    qnorm = float(jnp.linalg.norm(glv))
    if qnorm < 1.0:
        qnorm = 1.0

    with timers.phase("elastic_solve"):
        ue, _ = solve(lin, rhs, x0=u_fix)
    disp_el = np.asarray(ue)

    dl0 = 1.0 / nstep
    dl = dl0
    du = dl * ue

    zeros_gp6 = backend.gauss_zeros((6,))
    sig_new = zeros_gp6
    sig_old = zeros_gp6
    sig_test = zeros_gp6
    sig_yield = backend.gauss_full(params.sig_yield)
    peeq = backend.gauss_zeros()
    csr = backend.gauss_zeros()
    triax = backend.gauss_zeros()
    pressure_gp = backend.gauss_zeros()
    sigmises = backend.gauss_zeros()
    ecr = backend.gauss_zeros()
    pgp = backend.gauss_false()
    disp_new = jnp.zeros(ndof_pad, dtype=dtype)
    disp_old = jnp.zeros(ndof_pad, dtype=dtype)

    eigenvalues = None
    eigenvectors = None
    history = History()
    zero_disp = jnp.zeros(ndof_pad, dtype=dtype)

    # Displacement control: replace the load norm with the elastic reaction
    # on the driven boundary (fcVM.py:1169-1177).
    if has_movdof:
        disp_count()
        sn, st, pg, qelastic = backend.stress_update(
            coords, sig_yield, zero_disp, jnp.asarray(ue), zeros_gp6, et_e,
            large_disp,
        )
        qnorm = float(jnp.linalg.norm(movdof * qelastic))

    # Elastic buckling analysis + optional imperfection seeding
    # (fcVM.py:1195-1295).
    run_buckling = large_disp and not (nstep > 1 and params.max_imp == 0.0)
    if run_buckling:
        with timers.phase("buckling"):
            # initial stress field: elastic stresses of the full load
            # (radial return disabled by a huge yield stress, fcVM.py:1195).
            disp_count()
            sig_el_gp, _, _, _ = backend.stress_update(
                coords, 1.0e6 * sig_yield, zero_disp, jnp.asarray(ue),
                zeros_gp6, et_e, False,
            )
            eigenvalues, eigenvectors = backend.buckling(
                coords, sig_el_gp, k=2
            )
            log(f"buckling load factors: {eigenvalues}")

    if nstep == 1:
        # Elastic (and linear-buckling) analysis only (fcVM.py:1216-1223).
        disp_new = jnp.asarray(ue)
        history.lbd = [0.0, 1.0]
        history.load = [0.0, 1.0]
        history.un.append(float(jnp.max(jnp.abs(disp_new))))
        for lst in (history.crip, history.peeq, history.pressure, history.svm,
                    history.triax, history.ecr, history.csr, history.peeqmax):
            lst.append(lst[0])
        return _results(
            backend, disp_output, disp_new, disp_old, disp_el, eigenvalues,
            eigenvectors, sig_new, peeq, csr, sigmises, triax, sig_yield,
            history, gp_coords, volume, loadsums, False, coords_old,
            coords_np, timers, cg_stats,
        )

    if run_buckling and params.max_imp != 0.0:
        # Blend the two buckling modes into a geometric imperfection and
        # restart the analysis from the perturbed geometry (fcVM.py:1224-1295).
        ev1, ev2 = params.ev1, params.ev2
        v1, v2 = eigenvectors[:, 0], eigenvectors[:, 1]
        ua = ev1 / (ev1 + ev2) * v1 + ev2 / (ev1 + ev2) * v2
        ub = ev1 / (ev1 + ev2) * v1 - ev2 / (ev1 + ev2) * v2
        ma, mb = np.max(np.abs(ua)), np.max(np.abs(ub))
        if ma > mb:
            imper = params.max_imp / ma * np.sign(ua[np.argmax(np.abs(ua))]) * ua
        else:
            imper = params.max_imp / mb * np.sign(ub[np.argmax(np.abs(ub))]) * ub
        coords_np = coords_np + np.asarray(imper)[:ndof].reshape(-1, 3)
        coords = jnp.asarray(coords_np, dtype=dtype)
        esm, pinv, glv, rhs, gp_coords, volume, loadsums = assemble(coords_np)
        lin = _LinearState(esm, make_pc(esm, pinv, coords))
        qnorm = max(float(jnp.linalg.norm(glv)), 1.0)
        with timers.phase("elastic_solve"):
            ue, _ = solve(lin, rhs, x0=u_fix)
        disp_el = np.asarray(ue)
        dl = dl0
        du = dl * ue

    ue = jnp.asarray(ue)
    du = jnp.asarray(du)
    sig_new = zeros_gp6
    pgp = backend.gauss_false()

    lbd = [0.0]
    step = -1
    cnt = True
    fail = False
    mrr = False  # maximum-restarts-reached
    target_lf = params.target_lf
    disp_scale = 1.0  # continuation ("scale", v) override (fcVM.py:1657)
    iterat_tot = 0

    if resume_from is not None:
        # Restore the converged state of an earlier run's checkpoint
        # (new capability vs the reference, which has only the in-session
        # GUI continuation loop, fcVM.py:1659-1686).
        from fcvm_tpu.runtime.checkpoint import latest_step

        ck_step, st = latest_step(resume_from)
        if ck_step is not None:
            log(f"resuming from checkpoint step {ck_step}")
            disp_new = jnp.asarray(pad_vector(st["disp_new"], ndof_pad), dtype=dtype)
            disp_old = jnp.asarray(pad_vector(st["disp_old"], ndof_pad), dtype=dtype)
            du = jnp.asarray(pad_vector(st["du"], ndof_pad), dtype=dtype)
            # checkpoints store user element order; backends re-shard
            sig_new = backend.user_to_gauss(np.asarray(st["sig_new"], dtype=dtype))
            sig_test = backend.user_to_gauss(np.asarray(st["sig_test"], dtype=dtype))
            sig_yield = backend.user_to_gauss(np.asarray(st["sig_yield"], dtype=dtype))
            peeq = backend.user_to_gauss(np.asarray(st["peeq"], dtype=dtype))
            csr = backend.user_to_gauss(np.asarray(st["csr"], dtype=dtype))
            pgp = backend.user_to_gauss(np.asarray(st["pgp"]))
            lbd = list(st["lbd"])
            step = len(lbd) - 2
            dl = float(st["dl"]) if "dl" in st else (lbd[-1] - lbd[-2])
            history = History(**{
                k: list(st[f"hist_{k}"])
                for k in ("un", "load", "crip", "peeq", "pressure", "svm",
                          "triax", "ecr", "csr", "peeqmax", "lbd")
            })
            history.crip = [int(v) for v in history.crip]

    def do_residual(du_, lbd1):
        # the returned r is pre-scaled by relax inside the jit
        # (fcVM.py:1398-1400 applies it at the solve RHS) — a separate
        # eager `relax * r` per NR iteration would cost a dispatch
        disp_count()
        if refined:
            return backend.residual_refined(
                coords, sig_yield, disp_new, du_, sig_old, glv, lbd1,
                qnorm, et_e, large_disp, relax=relax,
            )
        return backend.residual(
            coords, sig_yield, disp_new, du_, sig_old, glv, lbd1, qnorm,
            et_e, large_disp, relax=relax,
        )

    def record_step(qin):
        nonlocal sig_yield, peeq, csr, triax, pressure_gp, sigmises, ecr
        disp_count(2)
        sig_yield, peeq, csr, triax, pressure_gp, sigmises, ecr = backend.update_peeq_csr(
            sig_test, sig_new, sig_yield, peeq, csr, et_e,
            params.ultimate_strain,
        )
        # history records the critical Gauss point in USER (ne, 4) order
        # (fcVM.py:1539-1557 parity), whichever backend element order.
        # All nine scalars come from ONE device program + ONE fetch — a
        # per-field gauss_to_user fetch would cost a full (ne, 4)
        # transfer, x6 per converged step.
        (un, maxloc, csr_v, pr_v, svm_v, tri_v, ecr_v, peeq_v,
         peeqmax) = jax.device_get(
            backend.record_stats(
                disp_new, csr, peeq, pressure_gp, sigmises, triax, ecr
            )
        )
        history.un.append(float(un))
        history.crip.append(int(maxloc))
        history.csr.append(float(csr_v))
        history.pressure.append(float(pr_v))
        history.svm.append(float(svm_v))
        history.triax.append(float(tri_v))
        history.ecr.append(float(ecr_v))
        history.peeq.append(float(peeq_v))
        history.peeqmax.append(float(peeqmax))
        if has_movdof:
            disp_count()
            history.load.append(float(sysm.masked_sum(movdof, qin)))
        else:
            history.load.append(lbd[step + 1])
        history.lbd.append(lbd[step + 1])
        if monitor is not None:
            # called AFTER this step's history scalars are appended, so a
            # monitor reading history.un/lbd sees the step it is being
            # shown the displacements of
            disp_nodes = np.asarray(disp_new).reshape(-1, 3)
            monitor(disp_nodes[: model.mesh.n_nodes], history)
        if checkpoint_path:
            from fcvm_tpu.runtime.checkpoint import save_state

            state = dict(
                disp_new=np.asarray(disp_new)[:ndof],
                disp_old=np.asarray(disp_old)[:ndof],
                du=np.asarray(du)[:ndof],
                sig_new=backend.gauss_to_user(sig_new),
                sig_test=backend.gauss_to_user(sig_test),
                sig_yield=backend.gauss_to_user(sig_yield),
                peeq=backend.gauss_to_user(peeq),
                csr=backend.gauss_to_user(csr),
                pgp=backend.gauss_to_user(pgp),
                lbd=np.asarray(lbd),
                dl=np.asarray(dl),
            )
            for k in ("un", "load", "crip", "peeq", "pressure", "svm",
                      "triax", "ecr", "csr", "peeqmax", "lbd"):
                state[f"hist_{k}"] = np.asarray(getattr(history, k))
            save_state(checkpoint_path, step + 1, state)

    any_pgp_h = None  # any(pgp) from the last fused iteration's fetch
    with timers.phase("stepping"):
        while cnt:
            cnt = False
            iriks = True
            pstep = 0
            while pstep < nstep and not mrr:
                step += 1
                pstep += 1
                restart = 0
                log(f"Step: {step}")
                a = du  # Riks control vector (fcVM.py:1316)
                if iriks:
                    sig_old = sig_new
                    lbd.append(lbd[step] + dl)
                else:
                    lbd[step + 1] = lbd[step] + dl

                sig_new, sig_test, pgp, qin, r, error_dev = do_residual(du, lbd[step + 1])
                error = float(error_dev)
                any_pgp_h = None
                iterat = 0
                log(f"Iteration: {iterat}, Error: {error:.2e}")
                eff_error_max = params.error_max
                floor_watch.reset(attempt=0)
                floor_watch.observe(error)

                while error > eff_error_max and not mrr:
                    iterat += 1
                    iterat_tot += 1

                    # Route this iteration: the fused single-dispatch
                    # composite (runtime/system.newton_iteration — SURVEY.md
                    # build-plan step 6) for the steady state; the unfused
                    # multi-dispatch path whenever host-side work must run
                    # mid-iteration (scipy tier, a deflation-space harvest,
                    # a load-space harvest, the f64 refinement mode).
                    fuse_now = (
                        fused_ok
                        and not refined
                        and not (use_deflation and lin.defl is None
                                 and defl_state["armed"])
                        and not (large_disp and use_ldefl
                                 and lstate["w"] is None and lstate["armed"])
                    )
                    if fuse_now:
                        t0 = time.perf_counter()
                        # the reference's re-factorization trigger
                        # (fcVM.py:1351) decided on host: iterat == 1, or
                        # any(pgp) carried back by the PREVIOUS fused
                        # iteration's scalar bundle (any_pgp_h; None =
                        # unknown after a restart/unfused iteration — one
                        # any_flag probe covers that rare case)
                        if large_disp:
                            refreshed = iterat == 1 or bool(
                                any_pgp_h if any_pgp_h is not None
                                else (disp_count() or sysm.any_flag(pgp))
                            )
                        else:
                            refreshed = False
                        itp_dev = None
                        if refreshed:
                            # dispatch the tangent refresh; its outputs
                            # flow straight into the fused program below —
                            # the two dispatches pipeline on device with
                            # no host sync between them
                            disp_count()
                            esm_t, pc_t, glv, ue, itp_dev = backend.tangent_refresh(
                                coords, sig_old, pgp, disp_new, du, lin.pc,
                                et_e, ue0=ue,
                                w=lstate["w"] if use_ldefl else None,
                                hp=hp_mode,
                            )
                            itp_dev.copy_to_host_async()
                            lin = _LinearState(esm_t, pc_t, defl=lin.defl)
                            if nr_trace:
                                tt1 = time.perf_counter()
                                jax.block_until_ready(esm_t)
                                log(f"NRTRACE it{iterat} f-tangent: "
                                    f"dispatch {tt1 - t0:.2f}s wait "
                                    f"{time.perf_counter() - tt1:.2f}s")
                        if nr_trace:
                            tn0 = time.perf_counter()
                        disp_count()
                        out = backend.newton_iteration(
                            coords, sig_yield, disp_new, du, sig_old, glv,
                            lbd[step], lbd[step + 1], qnorm, a, ue, r,
                            et_e, lin.esm, lin.pc, refreshed, large_disp,
                            defl=lin.defl, relax=relax,
                            crisfield=use_crisfield, hp=hp_mode,
                        )
                        if nr_trace:
                            tn1 = time.perf_counter()
                            jax.block_until_ready(out.error)
                            log(f"NRTRACE it{iterat} f-newton: dispatch "
                                f"{tn1 - tn0:.2f}s wait "
                                f"{time.perf_counter() - tn1:.2f}s")
                        for arr in (out.lbd1, out.cg_iters, out.any_pgp):
                            arr.copy_to_host_async()
                        # ONE bundled fetch per iteration: the mandatory
                        # convergence sync; every other scalar rides it
                        error, lbd1_h, it_h, any_pgp_h = map(
                            lambda v: v.item(),
                            jax.device_get((out.error, out.lbd1,
                                            out.cg_iters, out.any_pgp)),
                        )
                        lbd[step + 1] = float(lbd1_h)
                        du = out.du
                        sig_new, sig_test, pgp, qin, r = (
                            out.sig_new, out.sig_test, out.pgp, out.qin,
                            out.r,
                        )
                        cg_stats["solves"] += 1
                        cg_stats["iters"] += int(it_h)
                        # span includes the fused Riks/residual (and, on
                        # refresh iterations, the pipelined tangent) —
                        # see the end-of-run log note
                        cg_stats["time"] += time.perf_counter() - t0
                        cg_stats["fused_iterations"] += 1
                        if refreshed:
                            a = out.a
                            if lin.defl is not None:
                                lin.defl = out.defl  # re-Galerkined space
                            itp = int(itp_dev)  # ready: the bundle fetch
                            # above synced the downstream program
                            cg_stats["predictor_solves"] += 1
                            cg_stats["predictor_iters"] += itp
                            if use_ldefl:
                                # same load-space staleness policy as the
                                # unfused path (it only affects the NEXT
                                # refresh)
                                if (lstate["w"] is not None
                                        and itp >= cfg.deflation_refresh_iters):
                                    lstate["w"] = None
                                    log(f"load-deflation space stale "
                                        f"({itp} iters), will re-harvest")
                                elif (lstate["w"] is None
                                      and itp >= cfg.deflation_min_iters):
                                    lstate["armed"] = True
                        _solve_policy(lin, int(it_h))
                        log(f"Iteration: {iterat}, Error: {error:.2e}")
                    elif large_disp and (iterat == 1 or bool(sysm.any_flag(pgp))):
                        disp_count()  # the any_flag probe above
                        t0 = time.perf_counter()
                        # predictor solve: warm-started from the previous
                        # predictor (successive tangents differ by one
                        # Newton update; the rtol*||b|| criterion makes the
                        # warm start pay directly) and deflated with the
                        # LOAD-harvested Ritz basis (a residual-harvested
                        # one does nothing for load rhs — measured), which
                        # tangent_refresh re-Galerkins against the fresh
                        # operator in-jit.  When no load space is held, the
                        # refresh returns the assembled rhs instead and the
                        # harvesting solve below builds one.
                        # scipy tier: the direct factorization below is the
                        # predictor — don't pay a CG solve in-jit just to
                        # discard it
                        want_cg = cfg.solver != "scipy"
                        # (use_ldefl already implies the cg solver)
                        lharvest = (use_ldefl and lstate["w"] is None
                                    and lstate["armed"])
                        disp_count()
                        esm_t, pc_t, glv, out, itp = backend.tangent_refresh(
                            coords, sig_old, pgp, disp_new, du, lin.pc, et_e,
                            ue0=ue if want_cg else None,
                            w=lstate["w"] if use_ldefl else None,
                            solve_predictor=want_cg and not lharvest,
                            hp=hp_mode,
                        )
                        if nr_trace:
                            t_disp = time.perf_counter() - t0
                            jax.block_until_ready(out)
                            log(f"NRTRACE it{iterat} tangent: dispatch "
                                f"{t_disp:.2f}s wait "
                                f"{time.perf_counter() - t0 - t_disp:.2f}s")
                        if lharvest:
                            disp_count()
                            res_p, h_p = backend.solve_harvest(
                                esm_t, pc_t, out, x0=ue,
                                nstore=cfg.deflation_nstore, hp=hp_mode,
                            )
                            for arr in (res_p.iters, h_p.alphas, h_p.betas,
                                        h_p.rzs):
                                arr.copy_to_host_async()
                            ue = res_p.x.block_until_ready()
                            itp, alphas, betas, rzs = jax.device_get(
                                (res_p.iters, h_p.alphas, h_p.betas, h_p.rzs)
                            )
                            if int(itp) < cfg.deflation_min_iters:
                                lstate["armed"] = False
                            else:
                                from fcvm_tpu.ops import deflation as defl_ops

                                coef = defl_ops.ritz_coefficients(
                                    alphas, betas, rzs, int(itp),
                                    cfg.deflation_k,
                                )
                                if coef is not None:
                                    disp_count()
                                    lstate["w"] = backend.deflation_basis(
                                        h_p.zs, coef
                                    )
                                    log(f"load-deflation space "
                                        f"(predictor solve: {int(itp)} iters)")
                        elif want_cg:
                            itp.copy_to_host_async()
                            ue = out.block_until_ready()
                            itp = int(itp)
                            if (lstate["w"] is not None
                                    and itp >= cfg.deflation_refresh_iters):
                                lstate["w"] = None
                                log(f"load-deflation space stale ({itp} "
                                    "iters), will re-harvest")
                            elif (lstate["w"] is None
                                  and itp >= cfg.deflation_min_iters):
                                lstate["armed"] = True
                        if want_cg:
                            cg_stats["predictor_solves"] += 1
                            cg_stats["predictor_iters"] += int(itp)
                        cg_stats["tangent_time"] += time.perf_counter() - t0
                        defl_t = None
                        if use_deflation and lin.defl is not None:
                            # same basis, re-Galerkined on the new tangent
                            # operator (one block matvec; a stale Galerkin
                            # stays SPD but deflates the wrong scales)
                            disp_count()
                            if nr_trace:
                                tm0 = time.perf_counter()
                            defl_t = backend.make_deflation(esm_t, lin.defl.w)
                            if nr_trace:
                                tm1 = time.perf_counter()
                                jax.block_until_ready(defl_t.kw_inv)
                                log(f"NRTRACE it{iterat} make_defl: dispatch "
                                    f"{tm1 - tm0:.2f}s wait "
                                    f"{time.perf_counter() - tm1:.2f}s")
                        lin = _LinearState(esm_t, pc_t, defl=defl_t)
                        if cfg.solver == "scipy":
                            rhs_t = backend.scipy_rhs(esm_t, glv)
                            ue, _ = solve(lin, rhs_t, x0=u_fix)
                        disp_count()
                        a = sysm.scaled_control_vector(ue, du)

                    if not fuse_now:
                        if (use_deflation and lin.defl is None
                                and defl_state["armed"]):
                            due, _ = harvesting_solve(lin, r)
                            settle_solve = None
                        else:
                            # no device sync here: the Riks update + residual
                            # below are dispatched while the solve still runs;
                            # settle() fires at the convergence fetch, where
                            # the iters scalar is already on host (see solve())
                            if nr_trace:
                                ts0 = time.perf_counter()
                            due, settle_solve = solve(lin, r, defer=True)
                            if nr_trace:
                                ts1 = time.perf_counter()
                                jax.block_until_ready(due)
                                log(f"NRTRACE it{iterat} solve: dispatch "
                                    f"{ts1 - ts0:.2f}s wait "
                                    f"{time.perf_counter() - ts1:.2f}s")
                        # the settle runs in a finally so an exception between
                        # dispatch and the convergence fetch (monitor callbacks,
                        # device errors) cannot silently drop the solve from
                        # cg_stats or skip the recycling policy for it
                        try:
                            disp_count()
                            du, lbd1, _ = riks_fn(a, ue, due, du, lbd[step], lbd[step + 1])
                            # overlap the lambda fetch with the residual
                            # dispatch: do_residual takes the device scalar
                            # directly (same executable — jnp.asarray of a
                            # scalar either way) and the host reads both
                            # values after one completion sync
                            if hasattr(lbd1, "copy_to_host_async"):
                                lbd1.copy_to_host_async()
                            sig_new, sig_test, pgp, qin, r, error_dev = do_residual(du, lbd1)
                            lbd[step + 1] = float(lbd1)
                            error = float(error_dev)
                            any_pgp_h = None
                        finally:
                            if settle_solve is not None:
                                settle_solve()
                        log(f"Iteration: {iterat}, Error: {error:.2e}")

                    act = floor_watch.observe(error)
                    if act is not None and try_hp(f"at step {step}"):
                        # cheapest escalation tier: retry with the
                        # full-precision matvec before clamping, refining
                        # or restarting (fresh iteration budget, same as a
                        # restart re-probe)
                        iterat = 0
                        continue
                    if act == "escalate":
                        if refine_ok and not refined:
                            # first escalation tier: f64 residual
                            # refinement in-place, not a 2.8x f64 rerun;
                            # the refined attempt gets a fresh iteration
                            # budget (same as a restart re-probe)
                            activate_refinement(f"at step {step}")
                            iterat = 0
                            continue
                        raise PrecisionFloorError(
                            f"Newton error stagnant at "
                            f"~{min(floor_watch.errs):.2e} > error_max "
                            f"{params.error_max:g} at step {step}"
                            + (" (with f64 residual refinement)"
                               if refined else "")
                        )
                    if act is not None and act[1] > eff_error_max:
                        eff_error_max = act[1]
                        if step not in cg_stats["floor_clamp_steps"]:
                            cg_stats["floor_clamps"] += 1
                            cg_stats["floor_clamp_steps"].append(step)
                        log(
                            f"f32 RESIDUAL FLOOR at step {step}: error "
                            f"stagnant above error_max "
                            f"{params.error_max:g}; accepting this step at "
                            f"the noise-clamped tolerance {act[1]:.2e}"
                        )

                    if iterat > params.iterat_max:
                        # Before paying a restart: a roundoff-class stall
                        # (near-converged yet above error_max) with the
                        # default-precision matvec active is correction
                        # noise, not
                        # divergence — escalate the matvec instead of
                        # shrinking increments (fcVM.py:1457-1484 never
                        # restarts on roundoff; its corrections are exact)
                        if (floor_watch.escalate_at_mrr()
                                and try_hp(f"at iteration cap, step {step}")):
                            iterat = 0
                            continue
                        # Divergence restart with shrinking increments
                        # (fcVM.py:1457-1484).
                        restart += 1
                        log(f"RESTART # {restart}")
                        if restart > 4:
                            if (floor_watch.escalate_at_mrr()
                                    and try_hp(
                                        f"at restart exhaustion, step {step}"
                                    )):
                                # retry the ladder once with the
                                # full-precision matvec before the f64
                                # refinement / rerun tiers
                                restart = 1
                            elif (floor_watch.escalate_at_mrr()
                                    and refine_ok and not refined):
                                # roundoff-class abandonment: retry the
                                # whole restart ladder once with f64
                                # residual refinement before giving the
                                # step up or rerunning everything in f64
                                activate_refinement(
                                    f"at restart exhaustion, step {step}"
                                )
                                restart = 1
                            elif floor_watch.escalate_at_mrr():
                                raise PrecisionFloorError(
                                    "restarts exhausted with the Newton "
                                    f"error near-converged at "
                                    f"~{min(floor_watch.errs):.2e} "
                                    f"(> error_max {params.error_max:g}) "
                                    f"at step {step}"
                                    + (" (with f64 residual refinement)"
                                       if refined else "")
                                )
                            else:
                                log("MAXIMUM RESTARTS REACHED")
                                fail = False
                                step -= 1
                                del lbd[-1]
                                mrr = True
                                break
                        if step > 0:
                            dl = (lbd[step] - lbd[step - 1]) / params.scale_re / restart
                            du = (disp_new - disp_old) / params.scale_re / restart
                        else:
                            dl = dl0 / params.scale_re / restart
                            du = dl * ue / params.scale_re / restart
                        if refined and du.dtype != jnp.float64:
                            # keep the refined Newton increment in f64
                            # (the committed state may still be f32 when
                            # refinement activated mid-step)
                            du = du.astype(jnp.float64)
                        lbd[step + 1] = lbd[step] + dl
                        sig_new, sig_test, pgp, qin, r, error_dev = do_residual(du, lbd[step + 1])
                        # Reference quirk (fcVM.py:1480): restart residual uses
                        # lbd * glv for the external force like the main path;
                        # its "(glv + modf)" variant only perturbs the printed
                        # error, not the converged state.
                        error = float(error_dev)
                        any_pgp_h = None
                        iterat = 0
                        # fresh attempt: smaller increments lower the floor
                        # with the residual magnitudes, so re-probe (from
                        # attempt 1 on the watch may clamp/escalate)
                        eff_error_max = params.error_max
                        floor_watch.reset(attempt=restart)
                        floor_watch.observe(error)

                if mrr:
                    break

                if iriks and abs(target_lf - lbd[step]) < abs(lbd[step + 1] - lbd[step]):
                    # Intercept the target load factor exactly by linear
                    # rescaling of the final increment (fcVM.py:1486-1510).
                    log("REACHED TARGET LOAD")
                    fac = (target_lf - lbd[step]) / (lbd[step + 1] - lbd[step])
                    du = fac * du
                    sig_new = sig_old + fac * (sig_new - sig_old)
                    sig_test = sig_old + fac * (sig_test - sig_old)
                    lbd[step + 1] = target_lf
                    if has_movdof:
                        # consistent reaction for the interpolated state
                        # (divergence: the reference skips the rfl record
                        # here entirely, fcVM.py:1486-1523)
                        disp_count()
                        qin = backend.internal_force(
                            coords, sig_new, disp_new, large_disp
                        )
                    disp_new = disp_new + du
                    record_step(qin)
                    break
                else:
                    # Converged load step (fcVM.py:1515-1557).
                    disp_old = disp_new
                    dl = lbd[step + 1] - lbd[step]
                    factor = 1.0
                    if iterat > 10:
                        dl /= params.scale_dn
                        factor = 1.0 / params.scale_dn
                    if iterat < 5:
                        dl *= scale_up
                        factor = scale_up
                    disp_count()
                    disp_new, du = sysm.commit_step(disp_new, du, factor)
                    record_step(qin)
                    # Decay the harvest-based staleness bar once per
                    # converged step: the operator that harvest measured
                    # drifts with the plastic front, so a one-off hard
                    # harvest (e.g. 163 iters in a slender f32 regime) must
                    # not pin the bar for the rest of the run — if the
                    # problem eases, the bar sinks back toward
                    # deflation_refresh_iters and a re-harvest fires.
                    if defl_state.get("harvest_iters", 0) > cfg.deflation_refresh_iters:
                        defl_state["harvest_iters"] = max(
                            cfg.deflation_refresh_iters,
                            int(0.9 * defl_state["harvest_iters"]),
                        )
                    if not iriks:
                        break

            if continuation is not None and not mrr:
                action = continuation(history, dict(step=step, dl=dl, target_lf=target_lf))
                # The reference's plot loop exposes FOUR orthogonal controls
                # (fcVM.py:2004-2080): stop/add/rev buttons, a target-LF box
                # and a displacement-scale box (``ds``, fcVM.py:1657,1689) —
                # scale/target edits don't themselves resume the loop, the
                # buttons do.  Programmatically: one atomic action, or a
                # list/tuple of them applied in order (e.g.
                # ``[("scale", 20.0), "add"]`` or ``("add", "rev")``).
                # Atomic = None/"stop"/"add"/"rev" or a 2-tuple
                # ("target"|"scale", value); anything else iterable is a
                # sequence of atomic actions; unknown actions raise (a
                # silently-dropped typo'd action would just stop the loop).
                atomic = (
                    action is None
                    or isinstance(action, str)
                    or (isinstance(action, tuple) and len(action) == 2
                        and action[0] in ("target", "scale"))
                )
                actions = [action] if atomic else list(action)
                for act in actions:
                    if act == "add":
                        cnt = True
                    elif act == "rev":
                        cnt = True
                        dl = -dl
                        du = -du
                    elif isinstance(act, tuple) and len(act) == 2 and act[0] == "target":
                        cnt = True
                        target_lf = float(act[1])
                    elif isinstance(act, tuple) and len(act) == 2 and act[0] == "scale":
                        # displacement output scale for the deformed-geometry
                        # viewers (fcVM.py:1948: points = nocoord + ds*disp);
                        # recorded on the results and threaded into
                        # runtime.viz by api.run_analysis
                        disp_scale = float(act[1])
                    elif act is None or act == "stop":
                        pass
                    else:
                        raise ValueError(
                            f"unrecognized continuation action {act!r} "
                            "(expected 'stop'/'add'/'rev', ('target', v), "
                            "('scale', v), or a list of those)"
                        )

    log(f"total number of CG solves: {cg_stats['solves']}, iterations: {cg_stats['iters']}")
    if cg_stats["predictor_solves"]:
        log(f"tangent predictor solves: {cg_stats['predictor_solves']}, "
            f"iterations: {cg_stats['predictor_iters']}")
    # NR correction solves are settled at the convergence sync, so their
    # share of this total includes the pipelined Riks+residual dispatch
    # (the reference's synchronous factor(r) metric, fcVM.py:1620-1624,
    # has no overlap to account for)
    defer_note = (
        f" ({cg_stats['deferred_solves']} deferred solves' spans include "
        "the pipelined Riks+residual)"
        if cg_stats["deferred_solves"]
        else ""
    )
    log(f"total time evaluating K_inv * r: {cg_stats['time']:.3f}s{defer_note}")
    # the reference's end-of-run iteration total (fcVM.py:1620-1624)
    cg_stats["newton_iterations"] = iterat_tot
    log(f"total number of Newton iterations: {iterat_tot}")
    if cg_stats["solves"]:
        log(f"average time per solve: {cg_stats['time'] / cg_stats['solves']:.4f}s")
    if cg_stats["fused_iterations"]:
        log(f"fused Newton iterations: {cg_stats['fused_iterations']} of "
            f"{iterat_tot} (their solve spans include the in-jit "
            "tangent/Riks/residual)")
    if cg_stats["hp_matvec_activations"]:
        log("full-precision CG matvec active from step "
            f"{cg_stats['hp_from_step']} "
            f"({cg_stats['hp_matvec_activations']} activation(s))")
    # dispatch-latency telemetry: every driver-issued device program pays
    # per-call launch overhead — the quantity the fused iteration
    # minimizes, made observable here
    n_rec = max(len(history.lbd) - 1, 1)
    log(f"device dispatches: {cg_stats['dispatches']} "
        f"(~{cg_stats['dispatches'] / n_rec:.1f} per converged step)")

    history.load = history.load[: step + 2]
    return _results(
        backend, disp_output, disp_new, disp_old, disp_el, eigenvalues,
        eigenvectors, sig_new, peeq, csr, sigmises, triax, sig_yield,
        history, gp_coords, volume, loadsums, fail, coords_old, coords_np,
        timers, cg_stats, disp_scale=disp_scale,
    )


def _results(
    backend, disp_output, disp_new, disp_old, disp_el, eigenvalues,
    eigenvectors, sig_new, peeq, csr, sigmises, triax, sig_yield, history,
    gp_coords, volume, loadsums, fail, coords_old, coords_np, timers,
    cg_stats, disp_scale=1.0,
) -> AnalysisResults:
    ndof = 3 * len(coords_np)  # strip the dof-alignment padding
    disp_total = np.asarray(disp_new)[:ndof]
    disp = (
        disp_total
        if disp_output == "total"
        else disp_total - np.asarray(disp_old)[:ndof]
    )
    return AnalysisResults(
        disp=disp,
        disp_total=disp_total,
        disp_el=np.asarray(disp_el)[:ndof],
        eigenvalues=None if eigenvalues is None else np.asarray(eigenvalues),
        eigenvectors=(
            None if eigenvectors is None else np.asarray(eigenvectors)[:ndof]
        ),
        sig_gp=np.asarray(backend.gauss_to_user(sig_new)),
        peeq_gp=np.asarray(backend.gauss_to_user(peeq)),
        csr_gp=np.asarray(backend.gauss_to_user(csr)),
        svm_gp=np.asarray(backend.gauss_to_user(sigmises)),
        triax_gp=np.asarray(backend.gauss_to_user(triax)),
        sig_yield_gp=np.asarray(backend.gauss_to_user(sig_yield)),
        history=history,
        gp_coords=np.asarray(backend.gauss_to_user(gp_coords)),
        volume=float(volume),
        loadsums=np.asarray(loadsums),
        fail=fail,
        coords_old=coords_old,
        coords=coords_np,
        timers=timers.totals(),
        cg_stats=cg_stats,
        disp_scale=disp_scale,
    )
