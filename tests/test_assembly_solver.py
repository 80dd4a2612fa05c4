"""Assembly + matrix-free PCG vs scipy sparse direct, and physics checks."""

import jax
import jax.numpy as jnp
import numpy as np

from fcvm_tpu.models import meshgen
from fcvm_tpu.models.spec import BoundaryConditions, Loads
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import material as mat
from fcvm_tpu.ops.solver import ScipyDirectSolver, pcg
from fcvm_tpu.runtime import system as sysm

E, NU = 210000.0, 0.3
L = 10.0


def _cantilever(n=2, traction=(100.0, 0.0, 0.0)):
    mesh = meshgen.box_tet10(n, n, n, L, L, L)
    fixed = mesh.select_nodes(lambda x, y, z: x < 1e-9)
    bcs = BoundaryConditions.from_node_sets([(fixed, (0.0, 0.0, 0.0))])
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = Loads(
        traction_faces=faces, tractions=np.tile(traction, (len(faces), 1))
    )
    return mesh, bcs, loads


def _assemble(mesh, bcs, loads):
    coords = jnp.asarray(mesh.coords)
    eln = jnp.asarray(mesh.elnodes)
    dmat = mat.hooke_dmat(jnp.float64(E), jnp.float64(NU))
    fixmask, u_fix, _ = bcs.masks(mesh.ndof)
    lt = sysm.LoadTables.from_spec(loads, jnp.float64)
    out = sysm.assemble_elastic(
        coords, eln, dmat, lt, jnp.float64(0.0),
        jnp.asarray(fixmask), jnp.asarray(u_fix),
    )
    return coords, eln, fixmask, u_fix, out


def test_esm_symmetry_and_rigid_body():
    mesh, bcs, loads = _cantilever()
    coords, eln, fixmask, u_fix, (esm, *_rest) = _assemble(mesh, bcs, loads)
    esm_np = np.asarray(esm)
    assert np.abs(esm_np - esm_np.transpose(0, 2, 1)).max() < 1e-6
    # rigid translation produces zero force before BCs
    kv = asm.make_matvec(esm, asm.element_dof_ids(eln), mesh.ndof)
    rigid = jnp.asarray(np.tile([1.0, -2.0, 0.5], mesh.n_nodes))
    assert float(jnp.max(jnp.abs(kv(rigid)))) < 1e-6


def test_load_sums_and_volume():
    mesh, bcs, loads = _cantilever()
    _, _, _, _, (esm, pinv, glv, rhs, gpc, volume, loadsums) = _assemble(mesh, bcs, loads)
    np.testing.assert_allclose(np.asarray(loadsums), [100.0 * L * L, 0, 0], atol=1e-8)
    assert abs(float(volume) - L**3) < 1e-6


def test_cg_matches_scipy_direct():
    mesh, bcs, loads = _cantilever()
    _, eln, fixmask, _, (esm, pinv, glv, rhs, *_r) = _assemble(mesh, bcs, loads)
    res = sysm.solve_displacement(
        esm, eln, jnp.asarray(fixmask), pinv, rhs, 1e-12, 5000
    )
    direct = ScipyDirectSolver(esm, asm.element_dof_ids(eln), fixmask, mesh.ndof)
    xd = direct.solve(rhs)
    assert float(jnp.max(jnp.abs(res.x - xd))) < 1e-10 * float(jnp.max(jnp.abs(xd)))


def test_uniaxial_elastic_displacement():
    """Symmetry-constrained box in uniaxial tension: u = sigma L / E exactly."""
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
    sigma = 100.0
    bcs = BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        ]
    )
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = Loads(traction_faces=faces, tractions=np.tile([sigma, 0, 0], (len(faces), 1)))
    _, eln, fixmask, u_fix, (esm, pinv, glv, rhs, *_r) = _assemble(mesh, bcs, loads)
    res = sysm.solve_displacement(esm, eln, jnp.asarray(fixmask), pinv, rhs, 1e-12, 5000)
    u = np.asarray(res.x).reshape(-1, 3)
    end = mesh.select_nodes(lambda x, y, z: x > L - 1e-9)
    np.testing.assert_allclose(u[end, 0], sigma * L / E, rtol=1e-9)
    side = mesh.select_nodes(lambda x, y, z: y > L - 1e-9)
    np.testing.assert_allclose(u[side, 1], -NU * sigma * L / E, rtol=1e-8)


def test_prescribed_displacement_rhs():
    """Nonzero Dirichlet values reproduce the uniform-strain solution."""
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
    u0 = 0.05
    bcs = BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
            (mesh.select_nodes(lambda x, y, z: x > L - 1e-9), (u0, None, None)),
        ]
    )
    _, eln, fixmask, u_fix, (esm, pinv, glv, rhs, *_r) = _assemble(mesh, bcs, Loads())
    res = sysm.solve_displacement(esm, eln, jnp.asarray(fixmask), pinv, rhs, 1e-12, 5000)
    u = np.asarray(res.x).reshape(-1, 3)
    # linear ux(x) = u0 x / L everywhere
    np.testing.assert_allclose(u[:, 0], u0 * mesh.coords[:, 0] / L, atol=1e-10)


def test_pressure_follows_normal():
    """Pressure on the +x face of a box pulls in +x when positive."""
    mesh = meshgen.box_tet10(1, 1, 1, L, L, L)
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = Loads(pressure_faces=faces, pressures=np.full(len(faces), 2.0))
    lt = sysm.LoadTables.from_spec(loads, jnp.float64)
    glv = asm.pressure_face_loads(
        jnp.asarray(mesh.coords), lt.pressure_faces, lt.pressures, mesh.ndof
    )
    sums = np.asarray(glv).reshape(-1, 3).sum(axis=0)
    np.testing.assert_allclose(sums, [2.0 * L * L, 0, 0], atol=1e-9)


def test_edge_and_vertex_loads():
    mesh = meshgen.box_tet10(1, 1, 1, L, L, L)
    # an edge along x at y=0,z=0 consists of line3 (corner, corner, midside)
    nid = {tuple(np.round(c, 9)): i for i, c in enumerate(mesh.coords)}
    e1 = [nid[(0.0, 0.0, 0.0)], nid[(L, 0.0, 0.0)], nid[(L / 2, 0.0, 0.0)]]
    loads = Loads(edges=[e1], edge_tractions=[[0.0, 3.0, 0.0]])
    lt = sysm.LoadTables.from_spec(loads, jnp.float64)
    glv = asm.edge_loads(jnp.asarray(mesh.coords), lt.edges, lt.edge_tractions, mesh.ndof)
    sums = np.asarray(glv).reshape(-1, 3).sum(axis=0)
    np.testing.assert_allclose(sums, [0.0, 3.0 * L, 0.0], atol=1e-9)

    loads = Loads(vertices=[5], vertex_forces=[[1.0, 2.0, 3.0]])
    lt = sysm.LoadTables.from_spec(loads, jnp.float64)
    glv = asm.vertex_loads(lt.vertices, lt.vertex_forces, mesh.ndof, jnp.float64)
    np.testing.assert_allclose(np.asarray(glv)[15:18], [1.0, 2.0, 3.0])


def test_pcg_standalone():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(40, 40))
    a = a @ a.T + 40 * np.eye(40)
    b = rng.normal(size=40)
    amat = jnp.asarray(a)
    res = pcg(lambda v: amat @ v, jnp.asarray(b), rtol=1e-12, maxiter=200)
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(a, b), atol=1e-9)


def test_scatter_plan_matvec_matches_segment_sum():
    """The gather-only ScatterPlan path is exactly the segment_sum operator
    (same contributions, different summation tree)."""
    mesh, bcs, loads = _cantilever(n=3)
    coords, eln, fixmask, u_fix, (esm, pinv, glv, rhs, *_r) = _assemble(mesh, bcs, loads)
    plan = asm.build_scatter_plan(mesh.elnodes, mesh.ndof // 3)
    eldofs = asm.element_dof_ids(eln)
    kv_ref = asm.make_bc_matvec(esm, eldofs, jnp.asarray(fixmask))
    kv_plan = asm.make_bc_matvec(esm, eldofs, jnp.asarray(fixmask), plan)
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.normal(size=mesh.ndof))
    a, b = kv_ref(u), kv_plan(u)
    assert float(jnp.max(jnp.abs(a - b))) < 1e-11 * float(jnp.max(jnp.abs(a)))

    res_ref = sysm.solve_displacement(esm, eln, jnp.asarray(fixmask), pinv, rhs, 1e-12, 5000)
    res_plan = sysm.solve_displacement(
        esm, eln, jnp.asarray(fixmask), pinv, rhs, 1e-12, 5000, plan=plan
    )
    scale = float(jnp.max(jnp.abs(res_ref.x)))
    assert float(jnp.max(jnp.abs(res_ref.x - res_plan.x))) < 1e-9 * scale


def test_scatter_plan_stress_update_matches():
    from fcvm_tpu.ops.stress_update import update_stress_load

    mesh, bcs, loads = _cantilever(n=3)
    coords, eln, fixmask, u_fix, (esm, pinv, glv, rhs, *_r) = _assemble(mesh, bcs, loads)
    plan = asm.build_scatter_plan(mesh.elnodes, mesh.ndof // 3)
    ne = mesh.n_elements
    rng = np.random.default_rng(7)
    du = jnp.asarray(0.01 * rng.normal(size=mesh.ndof))
    args = (
        coords, eln, mat.hooke_dmat(jnp.float64(E), jnp.float64(NU)),
        jnp.full((ne, 4), 240.0), jnp.zeros(mesh.ndof), du,
        jnp.zeros((ne, 4, 6)), jnp.float64(E), jnp.float64(NU),
        jnp.float64(0.1), False,
    )
    s1, t1, p1, q1 = update_stress_load(*args)
    s2, t2, p2, q2 = update_stress_load(*args, plan)
    np.testing.assert_allclose(np.asarray(q1), np.asarray(q2), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


def test_chunked_block_builders_match_vmap(monkeypatch):
    """lax.map-chunked block/stress builders (the >2M-dof memory path)
    produce bitwise-identical results to the whole-mesh vmap."""
    import jax.numpy as jnp

    from fcvm_tpu.models import meshgen
    from fcvm_tpu.ops import assembly as asm
    from fcvm_tpu.ops import material as mat
    from fcvm_tpu.ops.stress_update import update_stress_load

    mesh = meshgen.box_tet10(2, 2, 2, 10.0, 10.0, 10.0)
    coords = jnp.asarray(mesh.coords)
    eln = jnp.asarray(mesh.elnodes)
    dmat = mat.hooke_dmat(jnp.asarray(210000.0), jnp.asarray(0.3))
    ne = mesh.n_elements
    sig = 0.1 * jnp.arange(ne * 24, dtype=coords.dtype).reshape(ne, 4, 6)
    pgp = (jnp.arange(ne * 4).reshape(ne, 4) % 3) == 0
    rng = np.random.default_rng(0)
    du = jnp.asarray(0.01 * rng.normal(size=mesh.ndof))
    sy = jnp.full((ne, 4), 25.0)

    ref_esm = asm.elastic_stiffness_blocks(coords, eln, dmat)
    ref_tan = asm.tangent_stiffness_blocks(
        coords, eln, dmat, sig, pgp, jnp.asarray(80769.2), jnp.asarray(0.0)
    )
    ref_geo = asm.geometric_stiffness_blocks(coords, eln, sig)
    ref_upd = update_stress_load(
        coords, eln, dmat, sy, jnp.zeros(mesh.ndof), du,
        jnp.zeros((ne, 4, 6)), jnp.asarray(210000.0), jnp.asarray(0.3),
        jnp.asarray(0.1), True,
    )

    monkeypatch.setattr(asm, "ASSEMBLY_CHUNK_THRESHOLD", 8)
    monkeypatch.setattr(asm, "ASSEMBLY_CHUNK", 16)
    # new trace caches: the jitted wrappers key on shapes only, so clear
    jax.clear_caches()
    try:
        np.testing.assert_array_equal(
            np.asarray(asm.elastic_stiffness_blocks(coords, eln, dmat)),
            np.asarray(ref_esm),
        )
        np.testing.assert_array_equal(
            np.asarray(asm.tangent_stiffness_blocks(
                coords, eln, dmat, sig, pgp, jnp.asarray(80769.2), jnp.asarray(0.0)
            )),
            np.asarray(ref_tan),
        )
        np.testing.assert_array_equal(
            np.asarray(asm.geometric_stiffness_blocks(coords, eln, sig)),
            np.asarray(ref_geo),
        )
        upd = update_stress_load(
            coords, eln, dmat, sy, jnp.zeros(mesh.ndof), du,
            jnp.zeros((ne, 4, 6)), jnp.asarray(210000.0), jnp.asarray(0.3),
            jnp.asarray(0.1), True,
        )
        for a, b in zip(upd, ref_upd):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    finally:
        jax.clear_caches()


def test_affine_cluster_basis_reproduces_affine_fields():
    """The 12-mode cluster basis must represent ANY affine displacement
    field u(x) = A x + b exactly within each cluster (that is what makes it
    a coarse space for smooth elasticity error); the 6-mode rigid basis
    must reproduce rigid motions but NOT general affine fields."""
    import jax.numpy as jnp

    from fcvm_tpu.ops.precond import _rigid_modes

    rng = np.random.default_rng(3)
    coords = jnp.asarray(rng.random((256, 3)) * 10.0)
    cs = 64

    amat = rng.normal(size=(3, 3))
    b = rng.normal(size=3)
    u_affine = np.asarray(coords) @ amat.T + b  # (nn, 3)
    skew = 0.5 * (amat - amat.T)
    u_rigid = np.asarray(coords) @ skew.T + b

    for nm, field, exact in (
        (6, u_rigid, True), (12, u_affine, True), (6, u_affine, False),
    ):
        q = np.asarray(_rigid_modes(coords, cs, nm))  # (nn_pad, 3, nm)
        nn = len(coords)
        resid_max = 0.0
        for c in range(nn // cs):
            rows = q[c * cs:(c + 1) * cs].reshape(cs * 3, nm)
            rhs = field[c * cs:(c + 1) * cs].reshape(-1)
            sol, res, *_ = np.linalg.lstsq(rows, rhs, rcond=None)
            r = np.linalg.norm(rows @ sol - rhs) / np.linalg.norm(rhs)
            resid_max = max(resid_max, r)
        if exact:
            assert resid_max < 1e-10, (nm, resid_max)
        else:
            assert resid_max > 1e-3, (nm, resid_max)


def test_chunked_coarse_inverse_matches_fused():
    """The blocked-Schur large-dimension coarse inversion (the path past
    the fused-compile size limit) matches the fused single-jit inverse to
    f32 roundoff."""
    import jax.numpy as jnp

    from fcvm_tpu.ops import precond as pc

    rng = np.random.default_rng(0)
    ncl, nm = 32, 6
    a = rng.normal(size=(ncl * nm, ncl * nm)).astype(np.float32)
    spd = a @ a.T + 50 * np.eye(ncl * nm, dtype=np.float32)
    kc = np.empty((ncl * ncl, nm * nm), np.float32)
    for aa in range(nm):
        for bb in range(nm):
            kc[:, aa * nm + bb] = spd[
                aa * ncl:(aa + 1) * ncl, bb * ncl:(bb + 1) * ncl
            ].reshape(-1)
    kc = jnp.asarray(kc)
    ridge = jnp.asarray(3e-4, jnp.float32)
    fused = pc._coarse_densify_invert(kc, ridge)
    blocked = pc.coarse_invert(kc, ridge, large_dim_threshold=64)
    err = np.max(np.abs(np.asarray(blocked) - np.asarray(fused))) / np.max(
        np.abs(np.asarray(fused))
    )
    assert err < 1e-5, err


def test_pcg_stagnation_exit_stops_at_arithmetic_floor():
    """``stall`` must (a) cut short solves that have reached their slow/
    floored regime, (b) NOT engage on a diverged solve (the 1e-3*||b||
    gate keeps the conservative run-to-maxiter behavior there), and
    (c) leave reachable-tolerance solves bit-identical."""
    import jax.numpy as jnp

    from fcvm_tpu.ops import solver as slv

    rng = np.random.default_rng(3)
    n = 400
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))

    # (a) cond 1e6 at f32: progress slows below 0.1%/iter long before
    # rtol 1e-12 — the stall exit stops early at a floored residual
    spd6 = jnp.asarray((q * np.logspace(0, -6, n)) @ q.T, dtype=jnp.float32)
    mv6 = lambda u: spd6 @ u
    res_burn = slv.pcg(mv6, b, rtol=1e-12, maxiter=5000)
    assert int(res_burn.iters) == 5000
    res_stall = slv.pcg(mv6, b, rtol=1e-12, maxiter=5000, stall=100)
    assert int(res_stall.iters) < 5000
    assert float(res_stall.relres) < 1e-2  # converged to a genuine floor

    # (b) cond 1e10 at f32: CG diverges (relres > 1); the gate must keep
    # it running to maxiter rather than "stalling out" early
    spd10 = jnp.asarray((q * np.logspace(0, -10, n)) @ q.T, dtype=jnp.float32)
    mv10 = lambda u: spd10 @ u
    res_div = slv.pcg(mv10, b, rtol=1e-12, maxiter=3000, stall=100)
    assert int(res_div.iters) == 3000

    # (c) reachable tolerance: identical path with and without stall
    res_a = slv.pcg(mv6, b, rtol=1e-3, maxiter=5000)
    res_b = slv.pcg(mv6, b, rtol=1e-3, maxiter=5000, stall=100)
    assert int(res_a.iters) == int(res_b.iters)
    np.testing.assert_allclose(np.asarray(res_a.x), np.asarray(res_b.x))


def test_matvec_precision_resolution(monkeypatch):
    """resolve_matvec_precision: full f32 einsum precision below the dof
    threshold (reduced-precision noise there bounds the Newton loop, seen
    on the Embankment replay), device default above, explicit modes
    forced."""
    import jax
    from fcvm_tpu import config as cfgmod

    cfg = cfgmod.get_config()
    monkeypatch.setattr(cfg, "matvec_precision", "auto")
    monkeypatch.setattr(cfg, "matvec_hp_max_dof", 200_000)
    assert asm.resolve_matvec_precision(81_000) == jax.lax.Precision.HIGHEST
    assert asm.resolve_matvec_precision(499_125) is None
    monkeypatch.setattr(cfg, "matvec_precision", "highest")
    assert asm.resolve_matvec_precision(499_125) == jax.lax.Precision.HIGHEST
    monkeypatch.setattr(cfg, "matvec_precision", "default")
    assert asm.resolve_matvec_precision(81_000) is None
