"""Headline benchmark: wall time per Newton load step, collapse analysis.

Prints the JSON line
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, "extra": {...}}
on stdout — possibly SEVERAL times, each a superset of the previous: a
reader takes the LAST JSON line, and re-emitting after every completed row
means a timeout mid-run loses only the rows not yet measured, never the
whole record.  Exits nonzero, measuring nothing, when JAX finds no GPU.

Metric: milliseconds per Riks/Newton load step (tangent stress updates +
preconditioned-CG solves, the reference's per-step hot path,
``fcVM.py:1304-1557``) on the NAMED baseline problem — the quarter
plate-with-hole collapse geometry (manual section 9.1, BASELINE.json
"(Plate_with_hole collapse)") at ~503k dof — driven into the plastic
regime (concentration-3 stress gradient, developed plastic front around
the hole), on one GPU in f32.  The assembly GDOF/s sub-metric is in
``extra.headline.assembly_gdof_s``; the rounds-0-4 box problem stays as
``extra.box_crosscheck`` for artifact continuity.

vs_baseline: speedup against a reference-style CPU *collapse* step measured
on the same machine — SuperLU factorization + triangular solves (the
stand-in for the reference's CHOLMOD backend, ``fcVM.py:66-71``) plus
vectorized numpy stress updates.  The factorization is part of the step:
under geometric nonlinearity the reference re-factorizes whenever any Gauss
point is plastic (``fcVM.py:1351-1396``), i.e. on every step of the collapse
regime.  The modified-NR (geometric-linear) ratio without the factor is also
logged.  Measured SAME-SIZE (the 503k-dof headline mesh — the BASELINE.md
north-star comparison; tens of minutes of one-core SuperLU fill-in, given
the tail of the wall budget) and matched-size (28.6k dof, where the direct
method is comfortable).  The CPU baseline never touches the GPU, so it runs
in a CPU-pinned SUBPROCESS concurrently with the device phases, emitting
each completed stage to a results file the parent folds in incrementally.

Time-limit resilience:

* phase order: device matched-size -> device headline -> EMIT -> capacity
  rows (each -> EMIT) -> sharded row -> EMIT (enrich-if-time-remains, per
  row; capacity first, since a recompile-heavy sharded row can starve
  them);
* ``FCVM_BENCH_BUDGET`` (seconds, default 3000): rows whose estimated cost
  exceeds the remaining budget are skipped with an explicit
  ``{"skipped": "budget"}`` marker instead of dying mid-measurement.

Extra diagnostics go to stderr; stdout carries only JSON lines.  The
line's ``extra`` field carries sub-rows: headline precond-build
times, the sharded-backend-on-one-device comparison
(``sharded_vs_local_row``, with an asserted ``max_lbd_diff`` tolerance),
and the capacity regime (1.07M / 1.98M dof — the >0.5M-node
gather-locality cliff, ``capacity_row``).  Knobs: ``FCVM_BENCH_CAPACITY``
(comma list of nx, default "35,43"),
``FCVM_BENCH_SHARDED(=0)``, ``FCVM_BENCH_SHARDED_NX``,
``FCVM_BENCH_BUDGET``.
"""

import json
import os
import sys
import time

import numpy as np

_T0 = time.perf_counter()


def log(*a):
    # elapsed stamp: the log's tail doubles as a phase-timing record (where
    # a timed-out run spent its budget)
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *a, file=sys.stderr,
          flush=True)


E, NU, SY = 210000.0, 0.3, 240.0
LBOX = 10.0
SIGMA = 100.0
ET_E = 0.1

NX_DEVICE = int(os.environ.get("FCVM_BENCH_NX", "27"))  # 3*(2*27+1)^3 ~ 499k dof
NX_CPU = int(os.environ.get("FCVM_BENCH_NX_CPU", "10"))  # direct-solver-feasible
N_SOLVES_PER_STEP = 3  # typical NR iterations per plastic load step
CG_RTOL = 1e-5

# Headline mesh: the NAMED baseline problem (BASELINE.json: "wall time per
# Newton load step + assembly GDOF/s (Plate_with_hole collapse)") at the
# north-star ~500k-dof scale — a quarter plate with a central hole under
# y-tension (manual section 9.1; examples/plate_with_hole.toml geometry),
# stress concentration ~3 at the hole, so the plastic step exercises a
# genuine stress gradient + plastic front instead of the box's
# near-uniform plasticity.  (2*54+1)(2*26+1)(2*14+1) nodes -> 502,599 dof.
PLATE_BIG = tuple(
    int(v) for v in os.environ.get("FCVM_BENCH_PLATE", "54,26,14").split(",")
)
# matched-size plate for the CPU-direct ratio (28.6k dof)
PLATE_SMALL = tuple(
    int(v)
    for v in os.environ.get("FCVM_BENCH_PLATE_SMALL", "16,8,8").split(",")
)
PLATE_SY = 100.0  # yield; 50 MPa applied -> net-section LF 1.6 (toml)
PLATE_SIGMA = 50.0


def build(nx):
    import fcvm_tpu
    from fcvm_tpu.models import meshgen

    mesh = meshgen.box_tet10(nx, nx, nx, LBOX, LBOX, LBOX)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        ]
    )
    faces = mesh.faces_on(lambda x, y, z: x > LBOX - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces, tractions=np.tile([SIGMA, 0, 0], (len(faces), 1))
    )
    return mesh, fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads)


def build_plate(size):
    """Quarter plate-with-hole under y-tension (the reference's headline
    collapse example, manual section 9.1; geometry of
    examples/plate_with_hole.toml scaled to ``size`` = (n_circ, n_rad,
    n_thick))."""
    import fcvm_tpu
    from fcvm_tpu.models import meshgen

    nc, nr, nt = size
    height = 100.0
    mesh = meshgen.plate_with_hole_tet10(
        radius=10.0, width=50.0, height=height, thickness=5.0,
        n_circ=nc, n_rad=nr, n_thick=nt,
    )
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        ]
    )
    faces = mesh.faces_on(lambda x, y, z: y > height - 1e-6)
    loads = fcvm_tpu.Loads(
        traction_faces=faces,
        tractions=np.tile([0.0, PLATE_SIGMA, 0.0], (len(faces), 1)),
    )
    return mesh, fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads)


def device_step_time(builder, sy=SY, drive=1.02, label=""):
    """Steady-state wall time of one plastic Riks load step on device.

    ``builder`` returns (mesh, model); ``sy`` is the yield stress and
    ``drive`` the load factor relative to first yield the step runs at
    (1.02 = just past yield for near-uniform fields like the box; 1.25
    for the plate headline, where the concentration-3 hole zone carries a
    developed plastic front while the net section stays elastic).  The
    yield load factor is derived on device from the elastic solution's
    peak von Mises stress, so the same harness drives any mesh/load into
    the plastic regime.
    """
    import jax
    import jax.numpy as jnp

    from fcvm_tpu.ops import assembly as asm_ops
    from fcvm_tpu.ops import material as mat
    from fcvm_tpu.ops.stress_update import update_stress_load
    from fcvm_tpu.runtime import system as sysm

    from fcvm_tpu.utils.indexing import pad_ndof, pad_vector

    dtype = jnp.float32
    mesh, model = builder()
    log(f"device {label}mesh: nn={mesh.n_nodes} ne={mesh.n_elements} ndof={mesh.ndof}")
    coords = jnp.asarray(mesh.coords, dtype)
    eln = jnp.asarray(mesh.elnodes)
    e = jnp.asarray(E, dtype)
    nu = jnp.asarray(NU, dtype)
    dmat = mat.hooke_dmat(e, nu)
    fixmask_np, u_fix_np, _ = model.bcs.masks(mesh.ndof)
    nd_pad = pad_ndof(mesh.ndof)

    from fcvm_tpu.config import get_config
    from fcvm_tpu.runtime.prewarm import start_precond_prewarm

    # exactly as the production driver (LocalSystem.__init__): AOT-prewarm
    # the precond-build executables on a daemon thread, overlapping the
    # setup + first assembly below
    cfg = get_config()
    if cfg.precond == "two_level" and cfg.prewarm:
        start_precond_prewarm(
            mesh.n_nodes, mesh.n_elements, nd_pad,
            cfg.resolve_cluster_size(mesh.n_nodes), cfg.coarse_modes, dtype,
        )

    fixmask = jnp.asarray(pad_vector(fixmask_np, nd_pad), dtype)
    u_fix = jnp.asarray(pad_vector(u_fix_np, nd_pad), dtype)
    lt = sysm.LoadTables.from_spec(model.loads, dtype)
    plan = asm_ops.build_scatter_plan(mesh.elnodes, nd_pad // 3)
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd_pad)

    t0 = time.perf_counter()
    esm, pinv, glv, rhs, gpc, vol, ls = jax.block_until_ready(
        sysm.assemble_elastic(coords, eln, dmat, lt, jnp.asarray(0.0, dtype), fixmask, u_fix, plan)
    )
    t_asm_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    esm, pinv, glv, rhs, gpc, vol, ls = jax.block_until_ready(
        sysm.assemble_elastic(coords, eln, dmat, lt, jnp.asarray(0.0, dtype), fixmask, u_fix, plan)
    )
    t_asm = time.perf_counter() - t0
    log(f"assembly: cold {t_asm_cold:.2f}s steady {t_asm * 1e3:.2f}ms "
        f"({mesh.ndof / t_asm / 1e6:.1f} MDOF/s)")

    t_build1 = t_build2 = 0.0
    if cfg.precond == "two_level":
        t0 = time.perf_counter()
        pc = jax.block_until_ready(
            sysm.build_precond(esm, eln, coords, fixmask,
                               cfg.resolve_cluster_size(mesh.n_nodes),
                               space=space)
        )
        t_build1 = time.perf_counter() - t0
        # first build pays residual jit compiles; the repeat
        # is the amortized cost a tangent refresh or reseed pays
        t0 = time.perf_counter()
        pc = jax.block_until_ready(
            sysm.build_precond(esm, eln, coords, fixmask,
                               cfg.resolve_cluster_size(mesh.n_nodes),
                               space=space)
        )
        t_build2 = time.perf_counter() - t0
        log(f"two-level precond build: {t_build1:.2f}s first "
            f"(incl. compile/cache load), {t_build2:.2f}s repeat")
    else:
        pc = pinv[space.nperm]

    maxiter = 5000

    def solve(b, defl=None):
        return sysm.solve_displacement(
            esm, eln, fixmask, pc, b, CG_RTOL, maxiter, plan=plan,
            space=space, defl=defl,
        )

    # Ritz recycling, exactly the production driver's policy
    # (runtime/driver.harvesting_solve): one correction solve harvests its
    # Lanczos byproducts; the space is RETAINED across steps and dropped
    # only when a deflated solve regresses past deflation_refresh_iters
    # (a per-step re-harvest measured perf-neutral: the undeflated harvest
    # solve eats the in-step savings).
    from fcvm_tpu.ops import deflation as defl_ops

    def harvesting_solve(b):
        res, h = sysm.solve_displacement_harvest(
            esm, eln, fixmask, pc, b, CG_RTOL, maxiter, plan=plan,
            space=space, nstore=cfg.deflation_nstore,
        )
        iters_h, alphas, betas, rzs = jax.device_get(
            (res.iters, h.alphas, h.betas, h.rzs)
        )
        defl = None
        if int(iters_h) < cfg.deflation_min_iters:
            state["armed"] = False  # easy solves: disarm (driver hysteresis)
        else:
            coef = defl_ops.ritz_coefficients(
                alphas, betas, rzs, int(iters_h), cfg.deflation_k
            )
            if coef is not None:
                defl = sysm.build_deflation(
                    esm, eln, fixmask, h.zs, jnp.asarray(coef), plan=plan,
                    space=space,
                )
        return res, int(iters_h), defl

    res = jax.block_until_ready(solve(rhs))  # compile + elastic predictor
    ue = res.x
    cg_iters = int(res.iters)
    log(f"elastic solve: {cg_iters} CG iters, relres {float(res.relres):.2e}")

    ne = mesh.n_elements
    sig_yield = jnp.full((ne, 4), sy, dtype)
    zeros6 = jnp.zeros((ne, 4, 6), dtype)
    et = jnp.asarray(ET_E, dtype)
    qnorm = jnp.asarray(float(jnp.linalg.norm(glv)), dtype)

    # derive the yield load factor from the elastic solution's peak von
    # Mises stress, then drive to `drive` x yield so the measured step is
    # genuinely plastic (a plastic FRONT on graded meshes like the plate)
    sig_el, _, _, _ = update_stress_load(
        coords, eln, dmat, 1e9 * sig_yield, jnp.zeros(nd_pad, dtype),
        jnp.asarray(ue), zeros6, e, nu, et, False, plan,
    )
    svm_max = float(mat.von_mises(sig_el)[2].max())
    lbd_yield = sy / svm_max
    lbd0 = drive * lbd_yield
    dl = 0.021 * lbd_yield  # the box's historical dl=0.05 at lbd_yield=2.4
    log(f"{label}yield LF {lbd_yield:.3f} (elastic svm_max {svm_max:.1f}); "
        f"stepping at lbd0={lbd0:.3f}, dl={dl:.4f}")
    disp = lbd0 * ue
    sig0, _, _, _ = update_stress_load(
        coords, eln, dmat, 1e9 * sig_yield, jnp.zeros(nd_pad, dtype),
        disp, zeros6, e, nu, et, False, plan,
    )

    iters_seen = []
    state = {"defl": None, "armed": True}

    def one_step():
        # The recycling policy (drop-if-stale / re-arm) is consulted at
        # step granularity here, not per solve: a synchronous per-solve
        # iters fetch costs a host round-trip during which the device
        # pipeline sits idle.
        # In the production driver the same fetch rides the NR loop's
        # mandatory per-iteration convergence sync, so per-solve
        # consultation is free there; the bench's fixed 3-solve step has
        # no such sync to ride.  In steady state the two granularities
        # take identical actions (no mid-step state transitions at either
        # bench size); only the D2H copies are started inside the loop.
        du = dl * ue
        pending = []
        t_start = time.perf_counter()
        sig_new = sig0
        for i in range(N_SOLVES_PER_STEP):
            sig_new, sig_test, pgp, qin, r, err = sysm.residual(
                coords, eln, dmat, sig_yield, disp, du, sig0, e, nu, et,
                glv, fixmask, jnp.asarray(lbd0 + dl, dtype), qnorm, False, plan,
            )
            if cfg.deflation and state["defl"] is None and state["armed"]:
                sres, it, state["defl"] = harvesting_solve(r)
                iters_seen.append(it)
            else:
                sres = solve(r, defl=state["defl"])
                sres.iters.copy_to_host_async()  # ride the final block
                pending.append((sres.iters, state["defl"] is not None))
                iters_seen.append(sres.iters)
            du = du + 0.1 * sres.x
        jax.block_until_ready((sig_new, du))
        t_step = time.perf_counter() - t_start
        if cfg.deflation:
            for dev_iters, had_defl in pending:
                it = int(dev_iters)
                if had_defl and it >= cfg.deflation_refresh_iters:
                    state["defl"] = None  # stale: next solve re-harvests
                elif state["defl"] is None and it >= cfg.deflation_min_iters:
                    state["armed"] = True
        return t_step

    one_step()  # warm every kernel + the one amortized harvest
    times = [one_step() for _ in range(3)]
    t_step = min(times)
    # plastic-front evidence for the row: fraction of Gauss points
    # past yield at the stepped state
    _, _, pgp_f, _, _, _ = sysm.residual(
        coords, eln, dmat, sig_yield, disp, dl * ue, sig0, e, nu, et,
        glv, fixmask, jnp.asarray(lbd0 + dl, dtype), qnorm, False, plan,
    )
    plastic_frac = float(jax.device_get(pgp_f.astype(jnp.float32).mean()))
    log(f"device {label}per-step: {t_step * 1e3:.1f} ms (3 runs: {[f'{t*1e3:.0f}' for t in times]}; "
        f"per-solve iters {[int(jax.device_get(i)) for i in iters_seen]}; "
        f"plastic GP fraction {plastic_frac:.3f})")
    diag = {
        "assembly_ms": round(t_asm * 1e3, 2),
        # the BASELINE.json headline sub-metric, explicit
        "assembly_gdof_s": round(mesh.ndof / t_asm / 1e9, 4),
        "precond_first_s": round(t_build1, 2),
        "precond_repeat_s": round(t_build2, 2),
        "elastic_iters": cg_iters,
        "lbd_yield": round(lbd_yield, 4),
        "lbd0": round(lbd0, 4),
        "plastic_gp_fraction": round(plastic_frac, 4),
    }
    return t_step, mesh.ndof, t_asm, cg_iters, diag


def cpu_step_time(builder, sy=SY, label=""):
    """Reference-style CPU step: SuperLU triangular solves + numpy stress
    update, same counts."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla

    from fcvm_tpu.ops import assembly as asm
    from fcvm_tpu.ops import material as mat
    from fcvm_tpu.ops.solver import assemble_scipy_csc

    dtype = jnp.float32
    mesh, model = builder()
    log(f"CPU-baseline {label}mesh: nn={mesh.n_nodes} ne={mesh.n_elements} ndof={mesh.ndof}")
    coords = jnp.asarray(mesh.coords, jnp.float32)
    eln = jnp.asarray(mesh.elnodes)
    dmat = mat.hooke_dmat(jnp.asarray(E, dtype), jnp.asarray(NU, dtype))
    esm = np.asarray(asm.elastic_stiffness_blocks(coords, eln, dmat), dtype=np.float64)
    fixmask_np, _, _ = model.bcs.masks(mesh.ndof)
    eldofs = np.asarray(asm.element_dof_ids(eln))
    k = assemble_scipy_csc(esm, eldofs, fixmask_np, mesh.ndof)
    t0 = time.perf_counter()
    lu = spla.splu(k)
    t_factor = time.perf_counter() - t0
    log(f"CPU factor: {t_factor:.2f}s")

    rng = np.random.default_rng(0)
    b = rng.normal(size=mesh.ndof)
    # one numpy stress update (vectorized == numba-class throughput)
    coords_el = np.asarray(mesh.coords)[mesh.elnodes]
    from fcvm_tpu.ops import elements as el

    dshp = el.DSHP10_AT_GP

    def numpy_stress_update(du):
        du_el = du.reshape(-1, 3)[mesh.elnodes]  # (ne, 10, 3)
        xs = np.einsum("eki,gjk->egij", coords_el, dshp)
        det = np.linalg.det(xs)
        xsi = np.linalg.inv(xs)
        dshpg = np.einsum("egki,gkj->egij", xsi, dshp)
        grad = np.einsum("eia,egbi->egab", du_el, dshpg)
        eps = 0.5 * (grad + grad.transpose(0, 1, 3, 2))
        tr = np.trace(eps, axis1=2, axis2=3)
        lam = E * NU / (1 + NU) / (1 - 2 * NU)
        g2 = E / (1 + NU)
        sig = g2 * eps
        sig[:, :, 0, 0] += lam * tr
        sig[:, :, 1, 1] += lam * tr
        sig[:, :, 2, 2] += lam * tr
        p = np.trace(sig, axis1=2, axis2=3) / 3
        dev = sig.copy()
        for i in range(3):
            dev[:, :, i, i] -= p
        svm = np.sqrt(1.5 * (dev**2).sum(axis=(2, 3)))
        fac = np.where(svm > sy, sy / np.maximum(svm, 1e-30), 1.0)
        sig = dev * fac[..., None, None]
        qin = np.einsum("egab,egbi,eg->eia", sig, dshpg, np.abs(det) * el.W10[None, :])
        out = np.zeros(mesh.ndof)
        np.add.at(out, (3 * mesh.elnodes[:, :, None] + np.arange(3)).reshape(-1), qin.reshape(-1))
        return out

    t0 = time.perf_counter()
    for _ in range(N_SOLVES_PER_STEP):
        x = lu.solve(b)
        q = numpy_stress_update(x * 1e-6)
    t_mnr = time.perf_counter() - t0
    log(f"CPU {label}modified-NR step (solves + stress updates): {t_mnr * 1e3:.1f} ms")
    t0 = time.perf_counter()
    lu2 = spla.splu(k)  # tangent re-factorization: the collapse-regime step
    t_refactor = time.perf_counter() - t0
    t_step = t_refactor + t_mnr
    log(f"CPU {label}collapse step (refactor + solves + updates): {t_step * 1e3:.1f} ms")
    return t_step, t_mnr, mesh.ndof, t_factor


def capacity_row(nx):
    """Capacity-regime stats (meshes past 1M dof): assembly, precond build,
    elastic-solve iterations, ms per CG iteration.  Returns one dict row
    for the JSON line."""
    import jax
    import jax.numpy as jnp

    from fcvm_tpu.config import get_config
    from fcvm_tpu.ops import assembly as asm_ops
    from fcvm_tpu.ops import material as mat
    from fcvm_tpu.runtime import system as sysm
    from fcvm_tpu.utils.indexing import pad_ndof, pad_vector

    dtype = jnp.float32
    mesh, model = build(nx)
    log(f"capacity mesh: nn={mesh.n_nodes} ne={mesh.n_elements} ndof={mesh.ndof}")
    coords = jnp.asarray(mesh.coords, dtype)
    eln = jnp.asarray(mesh.elnodes)
    dmat = mat.hooke_dmat(jnp.asarray(E, dtype), jnp.asarray(NU, dtype))
    fixmask_np, u_fix_np, _ = model.bcs.masks(mesh.ndof)
    nd_pad = pad_ndof(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(fixmask_np, nd_pad), dtype)
    u_fix = jnp.asarray(pad_vector(u_fix_np, nd_pad), dtype)
    lt = sysm.LoadTables.from_spec(model.loads, dtype)
    plan = asm_ops.build_scatter_plan(mesh.elnodes, nd_pad // 3)
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd_pad)

    t0 = time.perf_counter()
    esm, pinv, glv, rhs, gpc, vol, ls = jax.block_until_ready(
        sysm.assemble_elastic(coords, eln, dmat, lt, jnp.asarray(0.0, dtype),
                              fixmask, u_fix, plan)
    )
    t_asm_cold = time.perf_counter() - t0
    # free the cold-pass outputs BEFORE re-assembling: at 1.98M dof the
    # element blocks are 1.7 GB and rebinding in one statement keeps both
    # generations live across the repeat dispatch
    del esm, pinv, glv, rhs, gpc, vol, ls
    t0 = time.perf_counter()
    esm, pinv, glv, rhs, gpc, vol, ls = jax.block_until_ready(
        sysm.assemble_elastic(coords, eln, dmat, lt, jnp.asarray(0.0, dtype),
                              fixmask, u_fix, plan)
    )
    t_asm = time.perf_counter() - t0

    cfg = get_config()
    cs = cfg.resolve_cluster_size(mesh.n_nodes)
    t0 = time.perf_counter()
    pc = jax.block_until_ready(
        sysm.build_precond(esm, eln, coords, fixmask, cs, space=space)
    )
    t_build1 = time.perf_counter() - t0
    del pc  # same double-generation hazard as the assembly rebind above
    t0 = time.perf_counter()
    pc = jax.block_until_ready(
        sysm.build_precond(esm, eln, coords, fixmask, cs, space=space)
    )
    t_build2 = time.perf_counter() - t0

    def solve(b):
        return jax.block_until_ready(
            sysm.solve_displacement(esm, eln, fixmask, pc, b, CG_RTOL,
                                    5000, plan=plan, space=space)
        )

    res = solve(rhs)  # compile
    t0 = time.perf_counter()
    res = solve(rhs)
    t_solve = time.perf_counter() - t0
    iters = int(res.iters)
    row = {
        "ndof": mesh.ndof,
        "assembly_ms": round(t_asm * 1e3, 1),
        "assembly_cold_s": round(t_asm_cold, 1),
        "precond_first_s": round(t_build1, 2),
        "precond_repeat_s": round(t_build2, 2),
        "elastic_iters": iters,
        "elastic_solve_ms": round(t_solve * 1e3, 1),
        "ms_per_cg_iter": round(t_solve * 1e3 / max(iters, 1), 2),
    }
    log(f"capacity {mesh.ndof} dof: assembly {row['assembly_ms']} ms, "
        f"precond {t_build1:.2f}/{t_build2:.2f} s, elastic {iters} iters "
        f"@ {row['ms_per_cg_iter']} ms/iter")
    # free the big arrays before the next row
    del esm, pinv, glv, rhs, gpc, pc, res
    return row


def sharded_vs_local_row(nx):
    """ShardedSystem on a ONE-real-device mesh vs LocalSystem, end-to-end
    through the production collapse driver: identical physics expected,
    per-step wall delta measured.  This runs the shard_map kernels, as the
    device compiles them, on one card; precision traps in them are
    invisible on CPU."""
    import fcvm_tpu
    from fcvm_tpu.config import get_config

    cfg = get_config()
    _, model = build(nx)
    # Plastic (yield at LF 0.45 — below where the Riks scale-backs leave
    # step 2 at 499k dof) with 10% hardening — NO limit point, so the
    # equilibrium path stays contraction-stable and the asserted
    # tolerance measures KERNEL parity: near collapse two equally
    # converged backends walk chaotically diverging paths (2.35e-3 lbd
    # delta over 5 adaptive steps to LF~0.9, while the same kernels match
    # to 1.49e-8 on the stable path).  3 steps keep the row's two full
    # driver runs in budget.
    params = fcvm_tpu.ControlParams(
        sig_yield=25.0, nstep=3, error_max=1e-5, et_e=0.1,
        target_lf=99.0, gnl="GNLY", max_imp=0.0,
    )

    def run():
        res = fcvm_tpu.solve_collapse(model, params)
        nsteps = max(len(res.history.lbd) - 1, 1)
        return res, res.timers.get("stepping", 0.0) / nsteps

    res_l, t_l = run()
    old = cfg.force_sharded
    cfg.force_sharded = True
    try:
        res_s, t_s = run()
    finally:
        cfg.force_sharded = old
    lbd_l = np.asarray(res_l.history.lbd)
    lbd_s = np.asarray(res_s.history.lbd)
    nsh = min(len(lbd_l), len(lbd_s))
    lbd_diff = float(np.max(np.abs(lbd_l[:nsh] - lbd_s[:nsh])))
    # Asserted bound: the two backends' reduces are semantically identical
    # (CPU bit-parity 4.4e-16); on a device the remaining delta is f32
    # arithmetic noise through the Riks steps.  1e-4 on a lbd ~ 0.9
    # history is ~1e-4 relative — two orders below the 2.3e-3 path
    # divergence this bound exists to catch.
    lbd_tol = 1.0e-4
    row = {
        "ndof": 3 * len(model.mesh.coords),
        "lbd": [round(float(x), 6) for x in lbd_l.tolist()],
        "steps_local": len(lbd_l) - 1,
        "steps_sharded": len(lbd_s) - 1,
        "step_ms_local": round(t_l * 1e3, 1),
        "step_ms_sharded": round(t_s * 1e3, 1),
        "cg_iters_local": res_l.cg_stats["iters"],
        "cg_iters_sharded": res_s.cg_stats["iters"],
        # dispatch telemetry: the quantity the fused
        # Newton iteration minimizes, observable per backend
        "dispatches_local": res_l.cg_stats.get("dispatches"),
        "dispatches_sharded": res_s.cg_stats.get("dispatches"),
        "fused_iters_local": res_l.cg_stats.get("fused_iterations"),
        "fused_iters_sharded": res_s.cg_stats.get("fused_iterations"),
        "hp_activations_local": res_l.cg_stats.get("hp_matvec_activations"),
        "hp_activations_sharded": res_s.cg_stats.get("hp_matvec_activations"),
        "newton_iters_local": res_l.cg_stats.get("newton_iterations"),
        "newton_iters_sharded": res_s.cg_stats.get("newton_iterations"),
        "max_lbd_diff": lbd_diff,
        "lbd_tol": lbd_tol,
        "lbd_within_tol": bool(lbd_diff <= lbd_tol)
        and len(lbd_l) == len(lbd_s),
        "peeq_max_local": float(np.max(res_l.peeq_gp)),
        "peeq_max_sharded": float(np.max(res_s.peeq_gp)),
    }
    log(f"sharded(1-device mesh) vs local at {row['ndof']} dof: "
        f"step {row['step_ms_sharded']} vs {row['step_ms_local']} ms, "
        f"cg iters {row['cg_iters_sharded']} vs {row['cg_iters_local']}, "
        f"max lbd diff {lbd_diff:.2e} (tol {lbd_tol:g}, "
        f"ok={row['lbd_within_tol']})")
    if not row["lbd_within_tol"]:
        log("WARNING: sharded-vs-local lbd parity EXCEEDS the asserted "
            "bound — investigate before trusting the sharded backend")
    return row


def cpu_baseline_child(out_path):
    """Subprocess entry: matched-size AND same-size CPU baselines on a
    CPU-pinned JAX (the parent also sets ``JAX_PLATFORMS=cpu`` in its
    environment, so it can never open the GPU); runs concurrently with the
    parent's device phases.

    Emits a cumulative JSON line to stdout AND appends it to ``out_path``
    after every completed stage — the parent reads the file's last line at
    join time, so a same-size factorization that outruns the bench budget
    loses only the rows not yet measured (a 500k-dof 3D SuperLU factor on
    one core can take tens of minutes, the honest price of the direct
    method the matrix-free design replaces)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    result = {}

    def emit():
        line = json.dumps(result)
        print(line, flush=True)
        if out_path:
            with open(out_path, "a") as f:
                f.write(line + "\n")

    try:
        t_step, t_mnr, ndof, t_factor = cpu_step_time(
            lambda: build_plate(PLATE_SMALL), PLATE_SY, "matched ")
        result["matched"] = {"t_step": t_step, "t_mnr": t_mnr, "ndof": ndof,
                             "t_factor": t_factor}
    except Exception as err:
        result["matched"] = {"error": f"{type(err).__name__}: {err}"}
    emit()
    if os.environ.get("FCVM_BENCH_CPU_SAMESIZE", "1") not in (
        "0", "off", "false"
    ):
        # the north-star same-size row (BASELINE.md: ">= 10x per-load-step
        # wall time vs the CPU direct path on a 500k-DOF mesh")
        try:
            t_step, t_mnr, ndof, t_factor = cpu_step_time(
                lambda: build_plate(PLATE_BIG), PLATE_SY, "same-size ")
            result["same_size"] = {"t_step": t_step, "t_mnr": t_mnr,
                                   "ndof": ndof, "t_factor": t_factor}
        except Exception as err:
            result["same_size"] = {"error": f"{type(err).__name__}: {err}"}
        emit()


def start_cpu_baseline():
    """Launch the CPU baseline subprocess (stderr passes through).

    Returns (proc, results_path); the child appends cumulative JSON lines
    to results_path so partial progress survives a join timeout."""
    import subprocess
    import tempfile

    fd, path = tempfile.mkstemp(prefix="fcvm_bench_cpu_", suffix=".jsonl")
    os.close(fd)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-baseline", path],
        stdout=subprocess.DEVNULL, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    return proc, path


def join_cpu_baseline(proc, path, timeout):
    """Collect the CPU-baseline results (the file's LAST cumulative JSON
    line; None if nothing completed).  On timeout the child is left running
    and whatever stages it completed are still returned."""
    import subprocess

    try:
        proc.wait(timeout=max(timeout, 1.0))
        if proc.returncode != 0:
            log(f"CPU baseline subprocess exited rc={proc.returncode}")
    except subprocess.TimeoutExpired:
        log(f"CPU baseline subprocess still running after {timeout:.0f}s "
            "grace; taking its completed stages and stopping it")
        proc.kill()
        proc.wait()
    result = None
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    result = json.loads(line)
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    if result is None:
        log("CPU baseline subprocess produced no JSON stages")
    return result


def main():
    import jax

    if jax.default_backend() != "gpu":
        # never measure the CPU under the device metric's name
        print(f"bench: no GPU (JAX backend is {jax.default_backend()})",
              file=sys.stderr)
        sys.exit(2)
    from fcvm_tpu.config import enable_compilation_cache

    enable_compilation_cache()
    t_bench0 = time.perf_counter()
    budget = float(os.environ.get("FCVM_BENCH_BUDGET", "3000"))

    def left():
        return budget - (time.perf_counter() - t_bench0)

    record = {"metric": None, "value": None, "unit": "ms",
              "vs_baseline": None, "extra": {}}

    def emit():
        # Re-print the full line after every completed row: a reader takes
        # the LAST JSON line, so each print is a strictly better record
        # than the one before — and a timeout anywhere after the first
        # emit still leaves a complete headline line.
        print(json.dumps(record), flush=True)

    # the CPU baselines (matched-size AND same-size plate) never touch the
    # GPU: overlap them with everything; final join at the end of the run
    cpu_proc, cpu_path = start_cpu_baseline()

    # matched-size device measurement for the honest ratio (also warms the
    # hot kernels at small shapes) — SAME problem class as the headline
    # (plate with hole)
    t_dev_small, ndof_small, _, _, _ = device_step_time(
        lambda: build_plate(PLATE_SMALL), PLATE_SY, drive=1.25,
        label="matched ",
    )

    # HEADLINE: the named baseline problem (Plate_with_hole collapse,
    # BASELINE.json) at the north-star ~500k-dof scale
    t_dev, ndof, t_asm, cg_iters, diag = device_step_time(
        lambda: build_plate(PLATE_BIG), PLATE_SY, drive=1.25,
        label="headline ",
    )
    record["metric"] = (
        f"newton_load_step_wall_ms_plate_with_hole_{round(ndof / 1000)}kdof"
    )
    record["value"] = round(t_dev * 1e3, 2)
    record["extra"]["headline"] = diag

    def fold_cpu(cpu):
        """Fold whatever CPU-baseline stages have completed into the
        line.  vs_baseline is the SAME-SIZE collapse-step ratio (the
        BASELINE.md north star) when available, the matched-size ratio
        (measured this run, labeled) as fallback, and null otherwise —
        never a number from a prior round."""
        if cpu is None:
            record["vs_baseline"] = None
            record["extra"]["vs_baseline_from"] = "cpu baseline pending/failed"
            return
        m = cpu.get("matched")
        ms = {}
        if m and "t_step" in m:
            ms = {
                "ndof": m["ndof"],
                "cpu_collapse_step_ms": round(m["t_step"] * 1e3, 1),
                "cpu_mnr_step_ms": round(m["t_mnr"] * 1e3, 1),
                "device_step_ms": round(t_dev_small * 1e3, 1),
                "collapse_ratio": round(m["t_step"] / t_dev_small, 2),
                "mnr_only_ratio": round(m["t_mnr"] / t_dev_small, 2),
            }
            log(f"matched-size ({m['ndof']} dof): collapse-step speedup "
                f"{ms['collapse_ratio']}x (modified-NR-only "
                f"{ms['mnr_only_ratio']}x)")
        elif m:
            ms = dict(m)
        record["extra"]["matched_size"] = ms
        s = cpu.get("same_size")
        if s and "t_step" in s:
            record["extra"]["same_size"] = {
                "ndof": s["ndof"],
                "cpu_factor_s": round(s["t_factor"], 1),
                "cpu_collapse_step_ms": round(s["t_step"] * 1e3, 1),
                "cpu_mnr_step_ms": round(s["t_mnr"] * 1e3, 1),
                "device_step_ms": round(t_dev * 1e3, 1),
                "collapse_ratio": round(s["t_step"] / t_dev, 2),
                "mnr_only_ratio": round(s["t_mnr"] / t_dev, 2),
            }
            record["vs_baseline"] = round(s["t_step"] / t_dev, 3)
            record["extra"]["vs_baseline_from"] = (
                "same-size CPU collapse step (refactor + solves + updates)"
            )
            log(f"SAME-SIZE ({s['ndof']} dof): collapse-step speedup "
                f"{record['vs_baseline']}x, modified-NR-only "
                f"{record['extra']['same_size']['mnr_only_ratio']}x")
        else:
            if s:
                record["extra"]["same_size"] = dict(s)
            if "collapse_ratio" in ms:
                record["vs_baseline"] = ms["collapse_ratio"]
                record["extra"]["vs_baseline_from"] = (
                    f"matched-size ({ms['ndof']} dof) CPU collapse step; "
                    "same-size row pending/failed"
                )
            else:
                record["vs_baseline"] = None
                record["extra"]["vs_baseline_from"] = "cpu baseline failed"

    # non-blocking first look: the matched-size stage usually landed while
    # the device phases ran; the same-size factor gets the tail of the budget
    fold_cpu(join_cpu_baseline(cpu_proc, cpu_path, timeout=1.0))
    emit()

    # box cross-check row: the earlier headline problem, measured the same
    # way
    if os.environ.get("FCVM_BENCH_BOX", "1") not in (
        "0", "off", "false"
    ):
        if left() < 300.0:
            record["extra"]["box_crosscheck"] = {"skipped": "budget"}
        else:
            try:
                t_box, ndof_box, _, _, diag_box = device_step_time(
                    lambda: build(NX_DEVICE), SY, drive=1.02, label="box ",
                )
                record["extra"]["box_crosscheck"] = {
                    "ndof": ndof_box, "step_ms": round(t_box * 1e3, 2),
                    **diag_box,
                }
            except Exception as err:
                log(f"box cross-check FAILED: {type(err).__name__}: {err}")
                record["extra"]["box_crosscheck"] = {
                    "error": f"{type(err).__name__}: {err}"
                }
        emit()

    # capacity regime FIRST: 1.07M / 1.98M dof — these are pure
    # assemble/build/solve rows, cheaper and more load-bearing than the
    # sharded comparison, so they must not sit behind it in the budget
    # order (a recompile-heavy sharded row can starve them)
    cap_env = os.environ.get("FCVM_BENCH_CAPACITY", "35,43")
    if cap_env and cap_env not in ("0", "off", "false"):
        record["extra"]["capacity"] = []
        for nxs in cap_env.split(","):
            try:
                nx_cap = int(nxs)  # parse BEFORE the guard: a malformed
                # token must become an error row, not re-raise inside the
                # except handler and kill the JSON line
            except ValueError as err:
                log(f"capacity row nx={nxs!r} FAILED: {err}")
                record["extra"]["capacity"].append(
                    {"nx": nxs, "error": f"ValueError: {err}"}
                )
                continue
            if left() < 300.0:
                log(f"capacity row nx={nx_cap} skipped: {left():.0f}s "
                    "budget left (< 300)")
                record["extra"]["capacity"].append(
                    {"nx": nx_cap, "skipped": "budget"}
                )
                emit()
                continue
            try:
                # Drop the earlier rows' live executables and buffers
                # first, so the 1.98M-dof row starts from clean device
                # memory.  A fresh subprocess is NOT an option — one JAX
                # process per card.  Executables reload from the
                # persistent compile cache.
                import gc

                gc.collect()
                jax.clear_caches()
                record["extra"]["capacity"].append(capacity_row(nx_cap))
            except Exception as err:
                log(f"capacity row nx={nxs} FAILED: {type(err).__name__}: {err}")
                record["extra"]["capacity"].append(
                    {"nx": nx_cap, "error": f"{type(err).__name__}: {err}"}
                )
            emit()

    # sharded backend on one card (1-device mesh).  Two full
    # production-driver runs; cold compiles of the sharded closures can
    # take long — the budget guard protects the record, and the
    # incremental emits above mean a mid-row death loses only this row
    if os.environ.get("FCVM_BENCH_SHARDED", "1") not in (
        "0", "off", "false"
    ):
        if left() < 420.0:
            log(f"sharded row skipped: {left():.0f}s budget left (< 420)")
            record["extra"]["sharded_1dev"] = {"skipped": "budget"}
        else:
            try:
                import gc

                gc.collect()
                jax.clear_caches()
                record["extra"]["sharded_1dev"] = sharded_vs_local_row(
                    int(os.environ.get("FCVM_BENCH_SHARDED_NX", str(NX_DEVICE)))
                )
            except Exception as err:  # keep the JSON line alive
                log(f"sharded row FAILED: {type(err).__name__}: {err}")
                record["extra"]["sharded_1dev"] = {
                    "error": f"{type(err).__name__}: {err}"
                }
        emit()

    # final CPU-baseline join: give the same-size SuperLU factor (tens of
    # minutes on one core — the honest price of the direct method) the
    # remaining wall budget, then take whatever stages completed
    fold_cpu(join_cpu_baseline(cpu_proc, cpu_path, timeout=max(left(), 60.0)))
    emit()

    record["extra"]["wall_s"] = round(time.perf_counter() - t_bench0, 1)
    emit()


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--cpu-baseline":
        cpu_baseline_child(sys.argv[2])
    else:
        main()
