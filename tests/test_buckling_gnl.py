"""Buckling eigensolver + geometric-nonlinear path validation.

Euler column is the reference's own validation case (manual section 9.3,
``output files/Bar buckling.out``: 434.7 N vs 432 N theory).
"""

import jax.numpy as jnp
import numpy as np

import fcvm_tpu
from fcvm_tpu.models import meshgen

E, NU = 210000.0, 0.3


def _column_model(nx=8, ny=1, nz=1, lc=20.0, w=1.0, p=1000.0):
    mesh = meshgen.box_tet10(nx, ny, nz, lc, w, w)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))]
    )
    faces = mesh.faces_on(lambda x, y, z: x > lc - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces,
        tractions=np.tile([-p / (w * w), 0, 0], (len(faces), 1)),
    )
    return mesh, fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads)


def test_euler_column_buckling():
    lc, w, p = 20.0, 1.0, 1000.0
    mesh, model = _column_model(lc=lc, w=w, p=p)
    params = fcvm_tpu.ControlParams(gnl="GNLY", nstep=1)
    lam, vecs = fcvm_tpu.linear_buckling(model, params, k=2)
    p_cr = np.pi**2 * E * (w**4 / 12) / (4 * lc**2)  # clamped-free column
    # coarse tet10 mesh: a few % stiff; the two bending planes are degenerate
    np.testing.assert_allclose(lam, p_cr / p, rtol=0.03)
    assert abs(lam[0] - lam[1]) / lam[0] < 0.02
    # mode shapes: lateral deflection, max-normalized sign-fixed
    v = vecs.reshape(-1, 3, 2)
    assert np.abs(v[:, 0, :]).max() < 0.2 * np.abs(v).max()  # mostly lateral


def test_elastic_buckling_through_driver():
    """GNLY + nstep=1: solve_collapse runs the buckling branch
    (fcVM.py:1199-1223) and returns factors + elastic displacement."""
    mesh, model = _column_model()
    params = fcvm_tpu.ControlParams(gnl="GNLY", nstep=1, max_imp=0.0)
    res = fcvm_tpu.solve_collapse(model, params)
    assert res.eigenvalues is not None and len(res.eigenvalues) == 2
    lc, w, p = 20.0, 1.0, 1000.0
    p_cr = np.pi**2 * E * (w**4 / 12) / (4 * lc**2)
    np.testing.assert_allclose(res.eigenvalues, p_cr / p, rtol=0.03)
    # elastic axial shortening at full load
    end = mesh.select_nodes(lambda x, y, z: x > lc - 1e-9)
    ux = res.disp_total.reshape(-1, 3)[end, 0].mean()
    assert abs(ux - (-p * lc / (E * w * w))) < 0.05 * p * lc / (E * w * w)


def test_penalty_bc_cg_tier_matches_direct():
    """The penalty-BC pencil (fcVM.py:1051-1062 parity mode) must give the
    same factors from the matrix-free PCG tier (penalty block-Jacobi
    preconditioner, no elimination) as from the host direct tier."""
    from fcvm_tpu.config import get_config

    cfg = get_config()
    mesh, model = _column_model(nx=6)
    params = fcvm_tpu.ControlParams(gnl="GNLY", nstep=1)
    old_bc, old_solver = cfg.buckling_bc, cfg.solver
    try:
        cfg.buckling_bc = "penalty"
        cfg.solver = "scipy"
        lam_direct, _ = fcvm_tpu.linear_buckling(model, params, k=2)
        cfg.solver = "cg"
        lam_cg, vecs_cg = fcvm_tpu.linear_buckling(model, params, k=2)
    finally:
        cfg.buckling_bc, cfg.solver = old_bc, old_solver
    np.testing.assert_allclose(lam_cg, lam_direct, rtol=1e-7)
    # penalty modes still vanish (to ~1e-2 relative) on the clamped face
    v = np.abs(np.asarray(vecs_cg)).reshape(-1, 3, 2)
    clamped = mesh.select_nodes(lambda x, y, z: x < 1e-9)
    assert v[clamped].max() < 2e-2 * v.max()


def test_imperfection_seeding_perturbs_coords():
    mesh, model = _column_model()
    params = fcvm_tpu.ControlParams(
        gnl="GNLY", nstep=3, max_imp=0.05, ev1=1.0, ev2=0.0,
        error_max=1e-6, target_lf=0.05, sig_yield=1e6,
    )
    res = fcvm_tpu.solve_collapse(model, params)
    dc = np.abs(res.coords - res.coords_old).max()
    np.testing.assert_allclose(dc, 0.05, rtol=1e-9)  # maxImp applied exactly
    assert res.eigenvalues is not None


def test_gnl_stress_convection_rigid_rotation():
    """A rigid rotation increment convects the stress as R sigma R^T
    (fcVM.py:2383-2429) up to the small-angle spurious strain the
    reference's linearized deps also carries."""
    from fcvm_tpu.ops import material as mat
    from fcvm_tpu.ops.stress_update import update_stress_load

    mesh = meshgen.box_tet10(1, 1, 1, 1.0, 1.0, 1.0)
    coords = jnp.asarray(mesh.coords)
    eln = jnp.asarray(mesh.elnodes)
    ne = mesh.n_elements
    dmat = mat.hooke_dmat(jnp.float64(E), jnp.float64(NU))
    sig0 = np.tile([100.0, -40.0, 10.0, 5.0, -2.0, 7.0], (ne, 4, 1))

    phi = 1e-4
    c, s = np.cos(phi), np.sin(phi)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    du = (mesh.coords @ r.T - mesh.coords).reshape(-1)

    huge = jnp.full((ne, 4), 1e30)
    sig_new, _, _, _ = update_stress_load(
        coords, eln, dmat, huge, jnp.zeros(mesh.ndof), jnp.asarray(du),
        jnp.asarray(sig0), E, NU, 0.0, True,
    )
    t = np.zeros((3, 3))
    t[0, 0], t[1, 1], t[2, 2] = 100.0, -40.0, 10.0
    t[0, 1] = t[1, 0] = 5.0
    t[0, 2] = t[2, 0] = -2.0
    t[1, 2] = t[2, 1] = 7.0
    rt = r @ t @ r.T
    expect = np.array([rt[0, 0], rt[1, 1], rt[2, 2], rt[0, 1], rt[0, 2], rt[1, 2]])
    got = np.asarray(sig_new).reshape(-1, 6)
    # spurious elastic strain from the linearized deps is O(E * phi^2)
    np.testing.assert_allclose(got, np.tile(expect, (got.shape[0], 1)), atol=5e-3)


def test_gnl_driver_small_strain_matches_linear():
    """At small strains the GNL path must agree with the linear path."""
    lcase = 10.0
    mesh = meshgen.box_tet10(2, 2, 2, lcase, lcase, lcase)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        ]
    )
    faces = mesh.faces_on(lambda x, y, z: x > lcase - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces, tractions=np.tile([10.0, 0, 0], (len(faces), 1))
    )
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads)
    end = mesh.select_nodes(lambda x, y, z: x > lcase - 1e-9)

    res_lin = fcvm_tpu.solve_collapse(
        model,
        fcvm_tpu.ControlParams(sig_yield=240.0, nstep=4, error_max=1e-10, target_lf=1.0),
    )
    res_gnl = fcvm_tpu.solve_collapse(
        model,
        fcvm_tpu.ControlParams(
            sig_yield=240.0, nstep=4, error_max=1e-10, target_lf=1.0,
            gnl="GNLY", max_imp=0.0,
        ),
    )
    ux_lin = res_lin.disp_total.reshape(-1, 3)[end, 0].mean()
    ux_gnl = res_gnl.disp_total.reshape(-1, 3)[end, 0].mean()
    # strain 5e-5: geometric effects ~ O(strain) relative
    assert abs(ux_gnl - ux_lin) / abs(ux_lin) < 5e-4


def test_shallow_arch_snap_through():
    """Riks arc-length must trace past the limit point of a shallow pinned
    arch (the reference's snapback example family): the load factor peaks
    and then descends along the unstable branch while displacement grows."""
    from fcvm_tpu.models.spec import Mesh

    length, w, h, rise = 100.0, 5.0, 1.0, 8.0
    mesh0 = meshgen.box_tet10(32, 1, 1, length, w, h)
    c = mesh0.coords.copy()
    c[:, 2] += rise * (1 - ((2 * c[:, 0] / length) - 1) ** 2)
    mesh = Mesh(c, mesh0.elnodes)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: (x < 1e-9) & (z < 1e-6)), (0.0, 0.0, 0.0)),
            (mesh.select_nodes(lambda x, y, z: (x > length - 1e-9) & (z < 1e-6)), (0.0, 0.0, 0.0)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
        ]
    )
    top = mesh.faces_on(lambda x, y, z: (np.abs(x - length / 2) < length / 10) & (z > 6.0))
    loads = fcvm_tpu.Loads(
        traction_faces=top, tractions=np.tile([0, 0, -0.5], (len(top), 1))
    )
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads, name="arch")
    params = fcvm_tpu.ControlParams(
        sig_yield=1e5, nstep=30, iterat_max=40, error_max=1e-6,
        gnl="GNLY", max_imp=0.0, target_lf=999.0,
    )
    cont = lambda hist, info: "add" if len(hist.lbd) < 42 else "stop"
    res = fcvm_tpu.solve_collapse(model, params, continuation=cont)
    lbd = np.asarray(res.history.lbd)
    un = np.asarray(res.history.un)
    i_pk = int(np.argmax(lbd))
    assert 0 < i_pk < len(lbd) - 3  # a genuine interior limit point
    assert lbd[i_pk:].min() < 0.95 * lbd[i_pk]  # descending unstable branch
    assert un[-1] > un[i_pk]  # while displacement keeps growing
    assert res.peeq_gp.max() == 0.0  # purely geometric (elastic) instability


def test_buckling_deflation_matches_undeflated():
    """The deep Ritz-harvest recycling inside the eigensolve's k_inverse
    (runtime/buckling.py) must not move the eigenvalues: the deflation
    correction changes the CG path, not the converged solutions."""
    from fcvm_tpu import config as cfgmod

    mesh, model = _column_model(nx=12)
    params = fcvm_tpu.ControlParams(gnl="GNLY", nstep=1)
    cfg = cfgmod.get_config()

    def run(defl):
        old = cfg.deflation
        cfg.deflation = defl
        try:
            lam, vecs = fcvm_tpu.linear_buckling(model, params, k=2)
        finally:
            cfg.deflation = old
        return np.asarray(lam), np.asarray(vecs)

    lam_off, v_off = run(False)
    lam_on, v_on = run(True)
    np.testing.assert_allclose(lam_on, lam_off, rtol=1e-8)
    # modes are (-G)-normalized and sign-fixed: comparable directly
    np.testing.assert_allclose(v_on, v_off, atol=1e-6 * np.abs(v_off).max())


def test_cg_eigensolve_matches_direct_tier():
    """The CG-tier pencil eigensolve (with recycling, warm start and the
    PCG stagnation exit) must agree with the exact-direct scipy tier at
    f64 to eigensolve accuracy — guards the stagnation exit against
    premature truncation on plateaued (but converging) f64 solves."""
    from fcvm_tpu import config as cfgmod

    mesh, model = _column_model(nx=10)
    params = fcvm_tpu.ControlParams(gnl="GNLY", nstep=1)
    cfg = cfgmod.get_config()

    def run(solver):
        old = cfg.solver
        cfg.solver = solver
        try:
            lam, vecs = fcvm_tpu.linear_buckling(model, params, k=2)
        finally:
            cfg.solver = old
        return np.asarray(lam), np.asarray(vecs)

    lam_cg, v_cg = run("cg")
    lam_sp, v_sp = run("scipy")
    np.testing.assert_allclose(lam_cg, lam_sp, rtol=1e-6)
    # the two bending modes are (near-)degenerate, so individual vectors
    # are only defined up to a rotation within the pair — compare the
    # spanned SUBSPACE instead
    coef, *_ = np.linalg.lstsq(v_sp, v_cg, rcond=None)
    resid = v_cg - v_sp @ coef
    assert np.linalg.norm(resid) < 1e-4 * np.linalg.norm(v_cg)


def test_cruciform_torsional_buckling():
    """Torsional buckling of a cruciform column (manual section 9.4; the
    corpus ``cruciform_column.FCStd`` mesh is purged, so the specimen is
    regenerated parametrically).  With negligible warping stiffness the
    critical stress is the St Venant value sigma_cr = G J / I_p
    (Timoshenko), independent of length and boundary conditions; the
    voxel section's A/I_p are exact, J is thin-wall (2 w t^3 - t^4)/3.
    Measured FE factors bracket the analytic value within ~6% across
    resolutions (one quadratic element through the plate thickness)."""
    from fcvm_tpu.config import get_config

    b, t, lc, p = 40.0, 4.0, 200.0, 100.0
    mesh = meshgen.cruciform_tet10(b, t, lc, n_flange=4, n_thick=1, n_z=12)
    g = E / (2.0 * (1.0 + NU))
    w = 2 * b + t
    area = 2 * w * t - t * t
    ip = 2 * (t * w**3 / 12 + w * t**3 / 12) - t**4 / 6
    jt = (2 * w * t**3 - t**4) / 3.0
    sig_tor = g * jt / ip
    sig_euler = np.pi**2 * E * (t * w**3 / 12 + (w - t) * t**3 / 12) / (
        4 * lc**2 * area
    )
    assert sig_tor < 0.25 * sig_euler  # torsion governs by construction

    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: z < 1e-9), (0.0, 0.0, 0.0))]
    )
    top = mesh.faces_on(lambda x, y, z: z > lc - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=top, tractions=np.tile([0, 0, -p], (len(top), 1))
    )
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads)
    cfg = get_config()
    old = cfg.solver
    cfg.solver = "scipy"
    try:
        lam, vecs = fcvm_tpu.linear_buckling(
            model, fcvm_tpu.ControlParams(gnl="GNLY", nstep=1), k=2
        )
    finally:
        cfg.solver = old
    np.testing.assert_allclose(lam[0], sig_tor / p, rtol=0.10)
    # second mode: next torsional harmonic (warping-split), below flexure
    assert lam[0] < lam[1] < sig_euler / p
    # the mode is a twist: in-plane displacement aligned with theta x r
    v = np.asarray(vecs)[:, 0].reshape(-1, 3)
    tang = np.stack([-mesh.coords[:, 1], mesh.coords[:, 0]], axis=1)
    cos = abs(
        (v[:, :2] * tang).sum()
        / np.sqrt((v[:, :2] ** 2).sum() * (tang**2).sum())
    )
    assert cos > 0.6


def test_riks_update_crisfield_sphere_property():
    """The Crisfield update returns an increment exactly on the arc sphere
    |du_new| = |a| whenever the sphere is reachable, and lands on the
    stationary point otherwise."""
    from fcvm_tpu.runtime.system import riks_update_crisfield

    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.standard_normal(30))
    ue = jnp.asarray(rng.standard_normal(30))
    due = jnp.asarray(0.1 * rng.standard_normal(30))
    du = jnp.asarray(0.9 * np.asarray(a))
    du_new, lbd1, dl = riks_update_crisfield(a, ue, due, du, 0.0, 1.0)
    np.testing.assert_allclose(
        float(jnp.linalg.norm(du_new)), float(jnp.linalg.norm(a)), rtol=1e-12
    )
    assert float(lbd1) == 1.0 + float(dl)
    # continuity: the chosen root advances along the control vector
    assert float(jnp.vdot(a, du_new)) > 0.0


def test_snapback_crisfield_arc_length():
    """Snapback traversal — capability beyond the reference scheme.

    Specimen: the shallow arch driven through a soft laterally-guided ram
    (per-element materials: ram E = 1e-4 * arch E).  The equilibrium path
    in (load, ram-top displacement) folds back: past the limit point the
    stored ram compression releases faster than the apex descends, so the
    *monitored* displacement reverses while the load drops — snapback.
    The reference's linearized Riks + norm scale-back (fcVM.py:1414-1434,
    our default) stalls here at constant residual and exhausts its 4
    restarts (measured on this exact specimen); the spherical Crisfield
    constraint (config.arc_length = "crisfield") traverses the fold and
    continues down the unstable branch."""
    from fcvm_tpu.config import get_config
    from fcvm_tpu.models.spec import Mesh

    length, w, h, rise = 100.0, 5.0, 1.0, 8.0
    colh, cole_fac, nxc = 40.0, 1e-4, 32
    xs = np.linspace(0, length, nxc + 1)
    ys = np.array([0.0, w])
    zs = np.concatenate([[0.0, h], h + np.linspace(colh / 6, colh, 6)])
    cx0 = length / 2

    mesh0 = meshgen.grid_tet10(
        xs, ys, zs,
        keep=lambda cx, cy, cz: (cz < h) | (np.abs(cx - cx0) < length / nxc),
    )
    c = mesh0.coords.copy()
    arch = c[:, 2] <= h + 1e-9
    c[arch, 2] += rise * (1 - ((2 * c[arch, 0] / length) - 1) ** 2)
    c[~arch, 2] += rise  # the ram rides the apex, stays vertical
    mesh = Mesh(c, mesh0.elnodes)
    cent = mesh.coords[mesh.elnodes[:, :4]].mean(axis=1)
    mats = np.tile([E, NU, 0.0], (mesh.n_elements, 1))
    mats[cent[:, 2] > rise + h, 0] = E * cole_fac
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets([
        (mesh.select_nodes(lambda x, y, z: (x < 1e-9) & (z < 1e-6)), (0.0, 0.0, 0.0)),
        (mesh.select_nodes(lambda x, y, z: (x > length - 1e-9) & (z < 1e-6)), (0.0, 0.0, 0.0)),
        (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
        (mesh.select_nodes(lambda x, y, z: z > rise + h + 0.5), (0.0, 0.0, None)),
    ])
    ztop = float(mesh.coords[:, 2].max())
    top = mesh.faces_on(lambda x, y, z: z > ztop - 1e-6)
    loads = fcvm_tpu.Loads(
        traction_faces=top, tractions=np.tile([0, 0, -0.5], (len(top), 1))
    )
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads,
                           materials_by_element=mats, name="snapback")
    params = fcvm_tpu.ControlParams(
        sig_yield=1e5, nstep=40, iterat_max=40, error_max=1e-6,
        gnl="GNLY", max_imp=0.0, target_lf=999.0,
    )
    cfg = get_config()
    old_solver, old_arc = cfg.solver, cfg.arc_length
    cfg.solver, cfg.arc_length = "scipy", "crisfield"
    topn = mesh.select_nodes(lambda x, y, z: z > ztop - 1e-6)
    ut = [0.0]  # per-step ram-top displacement via the monitor hook
    try:
        res = fcvm_tpu.solve_collapse(
            model, params,
            continuation=lambda hist, info: "add" if len(hist.lbd) < 82 else "stop",
            monitor=lambda d, hist: ut.append(float(d[topn, 2].mean())),
        )
    finally:
        cfg.solver, cfg.arc_length = old_solver, old_arc

    lbd = np.asarray(res.history.lbd)
    n = min(len(lbd), len(ut))
    lbd, ut = lbd[:n], np.asarray(ut[:n])
    ipk = int(np.argmax(lbd))
    assert 8.5 < lbd[ipk] < 10.0 and 0 < ipk < n - 10  # interior limit point
    dut, dlb = np.diff(ut), np.diff(lbd)
    snapback = (dut > 0) & (dlb < 0)
    assert snapback.sum() >= 3  # the monitored displacement reverses...
    assert dut[snapback].sum() > 0.3  # ...by a finite recovery...
    assert lbd[-1] < 0.9 * lbd[ipk]  # ...while the load keeps descending
    assert res.peeq_gp.max() == 0.0  # purely geometric


def test_cruciform_imperfect_collapse_below_plastic_limit():
    """Manual section 9.4 phenomenology: an imperfection-seeded cruciform in
    the torsion/squash interaction regime (sigma_y chosen so the squash
    factor 7.5 ~ the elastic torsional factor) collapses slightly BELOW the
    plastic limit load, with plasticity active — torsional buckling and
    yielding interact (BASELINE.md 'ultimate slightly below plastic limit';
    the corpus document's mesh is purged, so the specimen is parametric)."""
    from fcvm_tpu.config import get_config

    b, t, lc, p, sy = 40.0, 4.0, 200.0, 100.0, 750.0
    mesh = meshgen.cruciform_tet10(b, t, lc, n_flange=3, n_thick=1, n_z=8)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: z < 1e-9), (0.0, 0.0, 0.0))]
    )
    top = mesh.faces_on(lambda x, y, z: z > lc - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=top, tractions=np.tile([0, 0, -p], (len(top), 1))
    )
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads)
    params = fcvm_tpu.ControlParams(
        sig_yield=sy, nstep=14, iterat_max=25, error_max=1e-8,
        et_e=0.0, gnl="GNLY", max_imp=0.4, ev1=1.0, ev2=0.0, target_lf=99.0,
    )

    def cont(h, i):
        if len(h.lbd) > 55:
            return "stop"
        if len(h.lbd) > 8 and max(h.lbd) > 3 and h.lbd[-1] < 0.93 * max(h.lbd):
            return "stop"
        return "add"

    cfg = get_config()
    old = cfg.solver
    cfg.solver = "scipy"
    try:
        res = fcvm_tpu.solve_collapse(model, params, continuation=cont)
    finally:
        cfg.solver = old
    squash = sy / p  # 7.5
    peak = max(res.history.lbd)
    assert res.eigenvalues is not None and res.eigenvalues[0] > squash * 0.9
    # ultimate: below the plastic limit AND the elastic buckling factor,
    # but not far below (interaction knock-down, not a premature failure)
    assert 0.80 * squash < peak < squash
    assert peak < res.eigenvalues[0]
    assert float(np.asarray(res.peeq_gp).max()) > 1e-5  # yielding occurred
    # the imperfection really was added to the geometry (torsional shape)
    np.testing.assert_allclose(
        np.abs(res.coords - res.coords_old).max(), 0.4, rtol=1e-9
    )


def test_pencil_residual_validation_catches_wrong_factors():
    """pencil_subspace must reject a finitely-converged NON-eigenpair.

    Observed on an accelerator (slender imperfect-column case): when the f32
    inner solves stall at their arithmetic floor, the subspace iteration
    satisfies its Cauchy exit on factors 51.9/69.3 vs the true 2.23/2.24 —
    all finite, so only the a-posteriori pencil residual (measured O(1)
    there vs ~1e-4 after the f64 retry) can route it to the failover.
    Reproduced here with a broken k_inverse (returns the rhs unsolved)."""
    import pytest

    from fcvm_tpu.runtime import buckling as bk

    rng = np.random.default_rng(0)
    n, k, m = 24, 2, 4
    a = rng.normal(size=(n, n))
    kmat = a @ a.T + n * np.eye(n)
    g = np.diag(rng.uniform(1.0, 5.0, size=n))  # SPD "geometric" matrix

    kmv = lambda w: jnp.asarray(kmat, w.dtype) @ w
    minus_g = lambda w: jnp.asarray(g, w.dtype) @ w
    kinv_exact = lambda w, x0_basis=None, x0_scale=None: jnp.asarray(
        np.linalg.solve(kmat, np.asarray(w, np.float64)), w.dtype
    )
    kinv_broken = lambda w, x0_basis=None, x0_scale=None: w  # "solves" nothing

    # positive control: exact inner solves -> genuine eigenpairs, no raise
    lam, _ = bk.pencil_subspace(
        kmv, minus_g, kinv_exact, n, jnp.float32, k, m
    )
    ref = np.sort(np.abs(np.linalg.eigvals(np.linalg.solve(g, kmat))))[:k]
    np.testing.assert_allclose(np.sort(lam), ref, rtol=1e-4)

    # broken inner solves converge the sweep onto (-G)-eigenpairs, which
    # are not pencil eigenpairs: the residual check must raise when a
    # further retry tier exists (f32 -> f64 -> host-direct ladder)...
    with pytest.raises(bk.EigensolveBreakdownError, match="pencil residual"):
        bk.pencil_subspace(kmv, minus_g, kinv_broken, n, jnp.float32, k, m)
    with pytest.raises(bk.EigensolveBreakdownError, match="pencil residual"):
        bk.pencil_subspace(kmv, minus_g, kinv_broken, n, jnp.float64, k, m)
    # ...and warn on the LAST tier (host-direct, or f64 past the
    # direct-failover size bound)
    with pytest.warns(UserWarning, match="pencil residual"):
        bk.pencil_subspace(kmv, minus_g, kinv_broken, n, jnp.float64, k, m,
                           last_tier=True)


def test_f32_eigensolve_breakdown_fails_over_to_f64(monkeypatch):
    """linear_buckling retries the pipeline in f64 on an f32 breakdown.

    Observed on an accelerator: the slender Euler-column pencil's projected
    Q^T K Q stays indefinite through the ridge ladder at f32 (the f32
    noise floor exceeds the small-eigenvalue block).  The wrapper must
    retry once in float64 and restore the pinned process dtype after."""
    import pytest

    from fcvm_tpu.config import get_config
    from fcvm_tpu.runtime import buckling as bk

    cfg = get_config()
    seen = []

    solver_seen = []

    def fake_impl(model, params, k=2):
        seen.append(str(cfg.resolve_dtype()))
        solver_seen.append(cfg.solver)
        if len(seen) == 1:
            raise bk.EigensolveBreakdownError("forced breakdown")
        return np.array([1.5, 2.5]), np.zeros((12, 2))

    monkeypatch.setattr(bk, "_linear_buckling_impl", fake_impl)

    class _FakeMesh:
        ndof = 12

    class _FakeModel:
        mesh = _FakeMesh()

    prev = cfg.dtype
    prev_solver = cfg.solver
    cfg.dtype = "float32"
    try:
        with pytest.warns(UserWarning, match="retrying the pipeline in float64"):
            lam, _ = bk.linear_buckling(_FakeModel(), object())
        np.testing.assert_allclose(lam, [1.5, 2.5])
        assert seen == ["float32", "float64"]
        # host-factorizable mesh: the retry escalates to the exact direct
        # solver tier (solver_seen records what the impl saw)
        assert solver_seen == [prev_solver, "scipy"] or prev_solver == "scipy"
        # the retry must not leak f64 (or the solver override) into the
        # rest of the process
        assert cfg.dtype == "float32"
        assert cfg.solver == prev_solver
    finally:
        cfg.dtype = prev
        cfg.solver = prev_solver


def test_reassembly_ladder_reaches_direct_tier(monkeypatch):
    """buckling_from_arrays walks f32 -> f64 iteration -> f64 re-assembly.

    Observed on the "Bar buckling" corpus pencil (cond ~1e10): both
    iterative tiers fail the pencil-residual validation because the
    f32-ASSEMBLED operands destroy the small buckling eigenvalues; only
    the f64 re-assembly + host-direct splu tier recovers.  The fake
    pencil solve reproduces that shape: raise while a retry tier exists,
    return a sentinel on the last tier."""
    import pytest

    from fcvm_tpu.config import get_config
    from fcvm_tpu.runtime import buckling as bk
    from fcvm_tpu.ops import material as mat

    mesh, _ = _column_model(nx=2)
    coords = jnp.asarray(mesh.coords, jnp.float32)
    elnodes = jnp.asarray(mesh.elnodes, jnp.int32)
    dmat = mat.hooke_dmat(jnp.float32(E), jnp.float32(NU))
    sig = jnp.zeros((mesh.n_elements, 4, 6), jnp.float32)
    fixmask = jnp.ones(mesh.ndof, jnp.float32)

    calls = []

    def fake_pencil(kmv, minus_g, k_inverse, ndof, dtype, k, m,
                    outer_tol=1.0e-9, max_outer=60, fixmask=None,
                    last_tier=False):
        calls.append((np.dtype(dtype).name, last_tier))
        if not last_tier:
            raise bk.EigensolveBreakdownError("forced: non-eigenpair")
        return np.array([0.43, 0.44])[:k], np.zeros((ndof, k))

    monkeypatch.setattr(bk, "pencil_subspace", fake_pencil)
    cfg = get_config()
    prev = cfg.dtype
    import jax

    x64_before = jax.config.read("jax_enable_x64")
    try:
        with pytest.warns(UserWarning, match="re-assembling the pencil"):
            lam, _ = bk.buckling_from_arrays(
                coords, elnodes, dmat, sig, fixmask, k=2
            )
        np.testing.assert_allclose(lam, [0.43, 0.44])
        # three tiers: f32, f64-on-f32-operands, f64-reassembled (last)
        assert calls == [
            ("float32", False), ("float64", False), ("float64", True)
        ]
        # the x64 flag must be restored for the continuing process
        assert jax.config.read("jax_enable_x64") == x64_before

        # the API path forbids internal re-assembly (linear_buckling
        # reruns the whole pipeline instead): the f64-iteration failure
        # must PROPAGATE, and caller_escalates keeps last_tier False
        calls.clear()
        with pytest.raises(bk.EigensolveBreakdownError):
            with pytest.warns(UserWarning, match="retrying the iteration"):
                bk.buckling_from_arrays(
                    coords, elnodes, dmat, sig, fixmask, k=2,
                    allow_reassembly=False,
                )
        assert calls == [("float32", False), ("float64", False)]
        assert jax.config.read("jax_enable_x64") == x64_before
    finally:
        cfg.dtype = prev
