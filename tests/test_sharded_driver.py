"""Multi-chip production driver: sharded vs single-device equivalence.

SURVEY.md's multi-chip correctness criterion: the same mesh run sharded and
single-device must produce the same load-displacement history.  These tests
run the FULL collapse driver (GNL tangent refresh, two-level preconditioner,
plastic radial return, displacement control) over an 8-virtual-device
element partition and compare whole histories in f64.
"""

import numpy as np
import pytest

import fcvm_tpu
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu.models.inp import ControlParams


def _box_model(n=3, traction=(100.0, 0.0, 0.0), sy=240.0):
    l = 10.0
    mesh = meshgen.box_tet10(n, n, n, l, l, l)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        ]
    )
    faces = mesh.faces_on(lambda x, y, z: x > l - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces, tractions=np.tile(traction, (len(faces), 1))
    )
    return fcvm_tpu.Model(
        mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads, name="shardbox"
    )


def _disp_model(n=2):
    """Displacement-controlled tension (movdof/rfl path)."""
    l = 10.0
    mesh = meshgen.box_tet10(n, n, n, l, l, l)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
            (mesh.select_nodes(lambda x, y, z: x > l - 1e-9), (0.05, None, None)),
        ]
    )
    return fcvm_tpu.Model(
        mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, fcvm_tpu.Loads(),
        name="sharddisp",
    )


def _run(model, params, n_devices):
    cfg = get_config()
    old = cfg.n_devices
    old_defl = cfg.deflation
    cfg.n_devices = n_devices
    # Equivalence tests compare bit-level histories (incl. crip argmax over
    # near-ties); run both backends with recycling off so the CG arithmetic
    # is identical.  Deflated sharded-vs-local equivalence is covered by
    # test_sharded_driver_deflation_matches_single_device (solver-tolerance
    # match) and physics preservation by tests/test_deflation.py.
    cfg.deflation = False
    try:
        return fcvm_tpu.solve_collapse(model, params)
    finally:
        cfg.n_devices = old
        cfg.deflation = old_defl


def _assert_history_match(r1, r8, tol=1e-10):
    np.testing.assert_allclose(r1.history.lbd, r8.history.lbd, atol=tol)
    np.testing.assert_allclose(r1.history.un, r8.history.un, atol=tol)
    np.testing.assert_allclose(r1.history.load, r8.history.load, atol=tol)
    np.testing.assert_allclose(r1.history.csr, r8.history.csr, atol=tol)
    assert r1.history.crip == r8.history.crip
    np.testing.assert_allclose(r1.disp_total, r8.disp_total, atol=tol)
    np.testing.assert_allclose(r1.peeq_gp, r8.peeq_gp, atol=tol)
    np.testing.assert_allclose(r1.sig_gp, r8.sig_gp, atol=1e-8)
    np.testing.assert_allclose(r1.volume, r8.volume, rtol=1e-12)
    np.testing.assert_allclose(r1.loadsums, r8.loadsums, atol=1e-9)


def test_sharded_plastic_gnl_collapse_matches_single_device():
    """Full plastic GNL multi-step collapse: the multi-device criterion
    (yielding steps, tangent refreshes, Riks corrections)."""
    params = ControlParams(
        sig_yield=60.0, nstep=6, error_max=1e-11, et_e=0.1,
        target_lf=99.0, gnl="GNLY", max_imp=0.0,
    )
    r1 = _run(_box_model(), params, 0)
    r8 = _run(_box_model(), params, 8)
    # plasticity must actually happen for this test to mean anything
    assert float(np.max(r8.peeq_gp)) > 1e-6
    _assert_history_match(r1, r8)


def test_force_sharded_one_device_mesh_matches_local():
    """cfg.force_sharded runs ShardedSystem on a 1-device mesh — the
    one-card validation path for the shard_map kernels (bench.py's
    sharded_1dev row)."""
    cfg = get_config()
    params = ControlParams(
        sig_yield=60.0, nstep=5, error_max=1e-11, et_e=0.1,
        target_lf=99.0, gnl="GNLY", max_imp=0.0,
    )
    r1 = _run(_box_model(), params, 0)
    old = cfg.force_sharded
    cfg.force_sharded = True
    try:
        from fcvm_tpu.runtime.backend import make_backend

        backend = make_backend(_box_model(), cfg, np.float64)
        assert type(backend).__name__ == "ShardedSystem"
        assert backend.n_shards == 1
        rs = _run(_box_model(), params, 0)
    finally:
        cfg.force_sharded = old
    _assert_history_match(r1, rs)


def test_sharded_geometric_linear_plastic_matches_single_device():
    params = ControlParams(
        sig_yield=60.0, nstep=5, error_max=1e-11, et_e=0.1, target_lf=99.0,
    )
    r1 = _run(_box_model(), params, 0)
    r8 = _run(_box_model(), params, 8)
    assert float(np.max(r8.peeq_gp)) > 1e-6
    _assert_history_match(r1, r8)


def test_sharded_displacement_control_matches_single_device():
    params = ControlParams(
        sig_yield=500.0, nstep=4, error_max=1e-11, et_e=0.1, target_lf=99.0,
    )
    r1 = _run(_disp_model(), params, 0)
    r8 = _run(_disp_model(), params, 8)
    assert r1.history.load[-1] > 0  # reaction-force level recorded
    _assert_history_match(r1, r8)


def test_sharded_restart_path_matches_single_device():
    """Force divergence restarts (tiny iterat_max) on both backends."""
    params = ControlParams(
        sig_yield=240.0, nstep=4, error_max=1e-11, et_e=0.1,
        target_lf=99.0, iterat_max=3,
    )
    r1 = _run(_box_model(), params, 0)
    r8 = _run(_box_model(), params, 8)
    _assert_history_match(r1, r8)


def test_sharded_uneven_element_count():
    """Element count not divisible by the shard count (ghost padding)."""
    m = _box_model(n=3)
    assert m.mesh.n_elements % 8 != 0 or True  # 162 elements % 8 = 2
    params = ControlParams(
        sig_yield=240.0, nstep=3, error_max=1e-11, et_e=0.1, target_lf=99.0,
    )
    r1 = _run(_box_model(3), params, 0)
    r5 = _run(_box_model(3), params, 5)
    _assert_history_match(r1, r5)


def test_checkpoint_cross_backend_resume(tmp_path):
    """A checkpoint written by the single-device driver resumes under the
    sharded backend: 2 steps local + 2 resumed sharded == 4 straight
    (checkpoints store user element order; backends re-shard on load)."""
    p2 = ControlParams(
        sig_yield=60.0, nstep=2, error_max=1e-11, et_e=0.1, target_lf=99.0,
    )
    ck = str(tmp_path / "ck")
    # 4 straight steps, single-device (2 + "add" 2 more)
    r_full = fcvm_tpu.solve_collapse(
        _box_model(), p2,
        continuation=lambda h, i: "add" if len(h.lbd) <= 3 else "stop",
    )
    fcvm_tpu.solve_collapse(_box_model(), p2, checkpoint_path=ck)
    cfg = get_config()
    cfg.n_devices = 8
    try:
        r_res = fcvm_tpu.solve_collapse(_box_model(), p2, resume_from=ck)
    finally:
        cfg.n_devices = 0
    np.testing.assert_allclose(
        r_full.history.lbd, r_res.history.lbd, atol=1e-10
    )
    np.testing.assert_allclose(r_full.disp_total, r_res.disp_total, atol=1e-10)
    np.testing.assert_allclose(r_full.peeq_gp, r_res.peeq_gp, atol=1e-12)


def test_sharded_buckling_and_imperfection_matches_single_device():
    """GNL + imperfection seeding: the sharded backend's pencil eigensolve
    and the imperfection-perturbed collapse match single-device."""
    l = 10.0
    def build():
        mesh = meshgen.box_tet10(2, 2, 8, 1.0, 1.0, l * 2)
        bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
            [(mesh.select_nodes(lambda x, y, z: z < 1e-9), (0.0, 0.0, 0.0))]
        )
        faces = mesh.faces_on(lambda x, y, z: z > 2 * l - 1e-9)
        loads = fcvm_tpu.Loads(
            traction_faces=faces,
            tractions=np.tile([0, 0, -1.0], (len(faces), 1)),
        )
        return fcvm_tpu.Model(
            mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads, name="col"
        )

    params = ControlParams(
        sig_yield=1e5, nstep=3, error_max=1e-10, et_e=0.0, target_lf=1e9,
        gnl="GNLY", max_imp=0.05, ev1=1.0, ev2=0.0,
    )
    r1 = _run(build(), params, 0)
    r8 = _run(build(), params, 8)
    np.testing.assert_allclose(r1.eigenvalues, r8.eigenvalues, rtol=1e-8)
    np.testing.assert_allclose(
        np.abs(r1.eigenvectors), np.abs(r8.eigenvectors), atol=1e-7
    )
    np.testing.assert_allclose(r1.history.lbd, r8.history.lbd, atol=1e-9)
    np.testing.assert_allclose(r1.history.un, r8.history.un, atol=1e-9)


def test_sharded_multi_material_matches_single_device():
    """Per-element material tables shard along the element partition
    (dmat/e/nu/density P('e') specs): a two-material series bar must give
    identical histories on both backends."""
    l = 10.0

    def build():
        mesh = meshgen.box_tet10(2, 2, 6, 2.0, 2.0, l)
        cent_z = mesh.coords[mesh.elnodes[:, :4], 2].mean(axis=1)
        mbe = np.where(
            (cent_z < l / 2)[:, None],
            np.array([[100000.0, 0.3, 0.0]]),
            np.array([[200000.0, 0.3, 0.0]]),
        )
        bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
            [
                (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
                (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
                (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            ]
        )
        faces = mesh.faces_on(lambda x, y, z: z > l - 1e-9)
        loads = fcvm_tpu.Loads(
            traction_faces=faces,
            tractions=np.tile([0, 0, 100.0], (len(faces), 1)),
        )
        return fcvm_tpu.Model(
            mesh, fcvm_tpu.Material(1.0, 0.3), bcs, loads,
            name="mm", materials_by_element=mbe,
        )

    params = ControlParams(
        sig_yield=60.0, nstep=4, error_max=1e-11, et_e=0.1, target_lf=99.0,
    )
    r1 = _run(build(), params, 0)
    r8 = _run(build(), params, 8)
    assert float(np.max(r8.peeq_gp)) > 1e-6  # soft half actually yields
    _assert_history_match(r1, r8)


def test_sharded_fewer_elements_than_devices():
    """ne=6 elements on 8 devices: some shards own only ghost padding."""
    mesh = meshgen.box_tet10(1, 1, 1, 10.0, 10.0, 10.0)
    assert mesh.n_elements == 6
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        ]
    )
    faces = mesh.faces_on(lambda x, y, z: x > 10.0 - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces, tractions=np.tile([100.0, 0, 0], (len(faces), 1))
    )
    model = fcvm_tpu.Model(
        mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads, name="tiny"
    )
    params = ControlParams(
        sig_yield=60.0, nstep=3, error_max=1e-11, et_e=0.1, target_lf=99.0,
    )
    r1 = _run(model, params, 0)
    r8 = _run(model, params, 8)
    _assert_history_match(r1, r8)


# ---------------------------------------------------------------------------
# Ritz-deflation recycling on the sharded backend
# ---------------------------------------------------------------------------


def _sharded_backend(model, n_devices=8):
    import jax.numpy as jnp

    from fcvm_tpu.runtime.backend import make_backend

    cfg = get_config()
    old = cfg.n_devices
    cfg.n_devices = n_devices
    try:
        return make_backend(model, cfg, jnp.float64)
    finally:
        cfg.n_devices = old


def test_sharded_block_matvec_matches_columnwise():
    """_khat_block_m == k applications of the scalar sharded matvec."""
    import jax.numpy as jnp

    model = _box_model()
    be = _sharded_backend(model)
    esm, pinv, glv, rhs, gpc, vol, ls = be.assemble(model.mesh.coords)
    rng = np.random.default_rng(7)
    w = jnp.asarray(rng.normal(size=(be.ndof_pad, 5)))
    kw = np.asarray(be._khat_block_m(esm, be.eln_m_s, be._plan_m, w))
    cols = np.stack(
        [np.asarray(be._khat_m(esm, be.eln_m_s, be._plan_m, w[:, j])) for j in range(5)], axis=1
    )
    np.testing.assert_allclose(kw, cols, rtol=1e-12, atol=1e-9)


def test_sharded_deflated_solve_same_solution_fewer_iters():
    """Harvest -> build space -> deflated re-solve on the sharded backend:
    same solution to solver tolerance, never more iterations."""
    from fcvm_tpu.ops import deflation as defl_ops

    model = _box_model(n=4)
    be = _sharded_backend(model)
    esm, pinv, glv, rhs, gpc, vol, ls = be.assemble(model.mesh.coords)
    pc = be.make_pc(esm, pinv, None)
    res1, h = be.solve_harvest(esm, pc, rhs, nstore=48)
    coef = defl_ops.ritz_coefficients(
        np.asarray(h.alphas), np.asarray(h.betas), np.asarray(h.rzs),
        int(res1.iters), 12,
    )
    assert coef is not None
    defl = be.build_deflation(esm, h.zs, coef)
    # basis vanishes on fixed dofs
    wb = np.asarray(defl.w)
    fix = np.asarray(be.space.fixmask_m)
    assert np.all(wb[fix < 0.5] == 0.0)
    res2 = be.solve(esm, pc, rhs, defl=defl)
    ref = np.asarray(res1.x)
    err = np.max(np.abs(np.asarray(res2.x) - ref)) / max(np.max(np.abs(ref)), 1e-30)
    assert err < 1e-6
    assert float(res2.relres) <= be.rtol
    assert int(res2.iters) < int(res1.iters)
    # re-Galerkin path returns the same correction on the same operator
    defl2 = be.make_deflation(esm, defl.w)
    np.testing.assert_allclose(
        np.asarray(defl2.kw_inv), np.asarray(defl.kw_inv), rtol=1e-8, atol=1e-12
    )


def test_sharded_driver_deflation_matches_single_device():
    """Full GNL plastic collapse with recycling forced ON for both backends:
    residual- and load-space harvests, retention, deflated predictor and
    correction solves all run sharded.  Both tiers converge every solve to
    rtol, so the histories agree to solver tolerance."""
    cfg = get_config()
    params = ControlParams(
        sig_yield=60.0, nstep=6, error_max=1e-11, et_e=0.1,
        target_lf=99.0, gnl="GNLY", max_imp=0.0,
    )

    def run(n_devices, logs):
        old_n, old_min = cfg.n_devices, cfg.deflation_min_iters
        cfg.n_devices = n_devices
        cfg.deflation_min_iters = 5  # tiny mesh: force harvesting
        try:
            return fcvm_tpu.solve_collapse(_box_model(), params,
                                           progress=logs.append)
        finally:
            cfg.n_devices = old_n
            cfg.deflation_min_iters = old_min

    logs1, logs8 = [], []
    r1 = run(0, logs1)
    r8 = run(8, logs8)
    assert any("deflation space: k=" in l for l in logs8)  # sharded harvest
    assert any("load-deflation space" in l for l in logs8)  # predictor space
    assert float(np.max(r8.peeq_gp)) > 1e-6
    np.testing.assert_allclose(r1.history.lbd, r8.history.lbd, atol=5e-7)
    np.testing.assert_allclose(r1.history.un, r8.history.un, atol=1e-7)
    np.testing.assert_allclose(r1.disp_total, r8.disp_total, atol=1e-7)


def test_sharded_buckling_deflation_matches_undeflated():
    """Deep-harvest recycling in the sharded eigensolve's k_inverse must
    not move the eigenvalues (same contract as the local tier)."""
    cfg = get_config()
    params = ControlParams(gnl="GNLY", nstep=1)

    def run(defl):
        old_n, old_d, old_m = cfg.n_devices, cfg.deflation, cfg.deflation_min_iters
        cfg.n_devices, cfg.deflation, cfg.deflation_min_iters = 8, defl, 5
        try:
            return fcvm_tpu.solve_collapse(_box_model(n=2, traction=(-100.0, 0.0, 0.0)), params)
        finally:
            cfg.n_devices, cfg.deflation, cfg.deflation_min_iters = old_n, old_d, old_m

    r_off = run(False)
    r_on = run(True)
    np.testing.assert_allclose(r_on.eigenvalues, r_off.eigenvalues, rtol=1e-8)


def test_sharded_crisfield_arc_matches_single_device():
    """config.arc_length='crisfield' routes through the backend-agnostic
    host loop: sharded and single-device histories must stay identical
    (the spherical update operates on replicated vectors only)."""
    cfg = get_config()
    old_arc = cfg.arc_length
    cfg.arc_length = "crisfield"
    try:
        params = ControlParams(
            sig_yield=60.0, nstep=5, error_max=1e-11, et_e=0.1,
            target_lf=99.0, gnl="GNLY", max_imp=0.0,
        )
        r1 = _run(_box_model(), params, 0)
        r8 = _run(_box_model(), params, 8)
    finally:
        cfg.arc_length = old_arc
    assert float(np.max(r8.peeq_gp)) > 1e-6
    _assert_history_match(r1, r8)


def test_node_partition_solve_matches_replicated():
    """config.node_partition: the in-shard_map row-sliced PCG (all_gather +
    psum_scatter per matvec, psum-reduced dots, sharded preconditioner and
    deflation applies) reproduces the replicated-vector solve bit-for-
    tolerance — plain, warm-started, and deflated."""
    import jax
    import jax.numpy as jnp

    from fcvm_tpu.ops import deflation as defl_ops
    from fcvm_tpu.parallel.system import ShardedSystem

    model = _box_model(n=3)
    cfg = get_config()
    old = cfg.n_devices
    cfg.n_devices = 8
    try:
        sh = ShardedSystem(model, cfg, jnp.float64)
    finally:
        cfg.n_devices = old
    esm, pinv, glv, rhs, _, _, _ = sh.assemble(model.mesh.coords)
    pc = sh.make_pc(esm, pinv, jnp.asarray(model.mesh.coords))

    res_rep = sh._solve_jit(esm, sh.eln_m_s, sh._plan_m, pc, rhs, None, None)
    res_h, h = sh.solve_harvest(esm, pc, rhs, nstore=64)
    coef = defl_ops.ritz_coefficients(
        *jax.device_get((h.alphas, h.betas, h.rzs)), int(res_h.iters), 16
    )
    defl = sh.build_deflation(esm, h.zs, jnp.asarray(coef))
    res_rep_d = sh._solve_jit(esm, sh.eln_m_s, sh._plan_m, pc, rhs, None, defl)

    old_np, old_n = cfg.node_partition, cfg.n_devices
    cfg.node_partition, cfg.n_devices = True, 8
    try:
        res_np = sh.solve(esm, pc, rhs)
        res_np_x0 = sh.solve(esm, pc, rhs, x0=0.9 * res_rep.x)
        res_np_d = sh.solve(esm, pc, rhs, defl=defl)
    finally:
        cfg.node_partition, cfg.n_devices = old_np, old_n

    assert int(res_np.iters) == int(res_rep.iters)
    np.testing.assert_allclose(
        np.asarray(res_np.x), np.asarray(res_rep.x), rtol=1e-12, atol=1e-15
    )
    assert int(res_np_d.iters) == int(res_rep_d.iters)
    np.testing.assert_allclose(
        np.asarray(res_np_d.x), np.asarray(res_rep_d.x),
        rtol=1e-12, atol=1e-15,
    )
    assert int(res_np_x0.iters) < int(res_np.iters)  # warm start helps
    assert float(res_np_x0.relres) <= sh.rtol  # converged to criterion
    scale = float(np.max(np.abs(np.asarray(res_rep.x))))
    # different iteration paths agree only to the rtol-level solve accuracy
    np.testing.assert_allclose(
        np.asarray(res_np_x0.x), np.asarray(res_rep.x),
        rtol=1e-3, atol=sh.rtol * scale,
    )


def test_node_partition_driver_matches_local():
    """Full collapse through the driver with the node-partitioned solver:
    history matches the single-device run (the replicated tiers' own
    equivalence bar)."""
    cfg = get_config()
    params = ControlParams(
        sig_yield=60.0, nstep=5, error_max=1e-11, et_e=0.1,
        target_lf=99.0, gnl="GNLY", max_imp=0.0,
    )
    r1 = _run(_box_model(), params, 0)
    old = cfg.node_partition
    cfg.node_partition = True
    try:
        rnp = _run(_box_model(), params, 8)
    finally:
        cfg.node_partition = old
    assert float(np.max(rnp.peeq_gp)) > 1e-6
    _assert_history_match(r1, rnp)


def test_sharded_system_ops_match_local():
    """Granular backend-op equivalence, ported from the retired
    ``parallel/sharding`` demo tests onto the production backend: assembly
    blocks, BC matvec, stress update and internal force from
    ``ShardedSystem`` match ``LocalSystem`` bit-for-tolerance in f64."""
    import jax.numpy as jnp

    from fcvm_tpu.ops import assembly as asm
    from fcvm_tpu.parallel.system import ShardedSystem
    from fcvm_tpu.runtime.backend import LocalSystem

    model = _box_model(n=2)
    cfg = get_config()
    loc = LocalSystem(model, cfg, jnp.float64)
    old = cfg.n_devices
    cfg.n_devices = 8
    try:
        sh = ShardedSystem(model, cfg, jnp.float64)
    finally:
        cfg.n_devices = old

    coords = model.mesh.coords
    ne = model.mesh.n_elements
    esm_l, pinv_l, glv_l, rhs_l, gpc_l, vol_l, ls_l = loc.assemble(coords)
    esm_s, pinv_s, glv_s, rhs_s, gpc_s, vol_s, ls_s = sh.assemble(coords)

    # element blocks: sharded blocks are Morton-ordered + ghost-padded
    np.testing.assert_allclose(
        sh.gauss_to_user(esm_s), np.asarray(esm_l), rtol=1e-10, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(glv_s), np.asarray(glv_l), rtol=1e-10, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(rhs_s), np.asarray(rhs_l), rtol=1e-10, atol=1e-8
    )
    np.testing.assert_allclose(float(vol_s), float(vol_l), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(ls_s), np.asarray(ls_l), rtol=1e-10, atol=1e-8
    )
    np.testing.assert_allclose(
        sh.gauss_to_user(gpc_s), np.asarray(gpc_l), rtol=1e-12, atol=1e-12
    )

    # Dirichlet-projected matvec: one psum over the element partition must
    # equal the single-device gather/matmul/scatter operator
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.normal(size=loc.ndof_pad))
    kv_local = asm.make_bc_matvec(
        esm_l, asm.element_dof_ids(loc.elnodes), loc.fixmask, loc.plan
    )
    y_l = np.asarray(kv_local(u))
    y_s = np.asarray(sh.space.from_m(sh._khat_m(esm_s, sh.eln_m_s, sh._plan_m, sh.space.to_m(u))))
    np.testing.assert_allclose(y_s, y_l, rtol=1e-10, atol=1e-8)

    # GNL stress update + internal force on a random plastic-ish state
    disp = jnp.asarray(rng.normal(size=loc.ndof_pad) * 1e-3)
    du = jnp.asarray(rng.normal(size=loc.ndof_pad) * 1e-4)
    sig_old_np = rng.normal(size=(ne, 4, 6)) * 50.0
    sy = 240.0
    coords_dev = jnp.asarray(coords)
    sn_l, st_l, pgp_l, qin_l = loc.stress_update(
        coords_dev, loc.gauss_full(sy), disp, du, jnp.asarray(sig_old_np),
        0.1, True,
    )
    sn_s, st_s, pgp_s, qin_s = sh.stress_update(
        coords_dev, sh.gauss_full(sy), disp, du, sh.user_to_gauss(sig_old_np),
        0.1, True,
    )
    np.testing.assert_allclose(
        sh.gauss_to_user(sn_s), np.asarray(sn_l), rtol=1e-10, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(qin_s), np.asarray(qin_l), rtol=1e-9, atol=1e-8
    )
    np.testing.assert_array_equal(sh.gauss_to_user(pgp_s), np.asarray(pgp_l))

    qf_l = np.asarray(loc.internal_force(coords_dev, sn_l, disp, True))
    qf_s = np.asarray(sh.internal_force(coords_dev, sn_s, disp, True))
    np.testing.assert_allclose(qf_s, qf_l, rtol=1e-9, atol=1e-8)


def test_sharded_buckling_breakdown_falls_back_to_local_ladder(monkeypatch):
    """A pencil-residual breakdown in the SPMD eigensolve must escalate
    through the local retry ladder (buckling_from_arrays), not abort the
    analysis — the driver calls backend.buckling() with no try/except
    (runtime/driver.py), so the sharded backend owns its own failover."""
    from fcvm_tpu.runtime import buckling as bk

    l = 10.0

    def build():
        mesh = meshgen.box_tet10(2, 2, 8, 1.0, 1.0, l * 2)
        bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
            [(mesh.select_nodes(lambda x, y, z: z < 1e-9), (0.0, 0.0, 0.0))]
        )
        faces = mesh.faces_on(lambda x, y, z: z > 2 * l - 1e-9)
        loads = fcvm_tpu.Loads(
            traction_faces=faces,
            tractions=np.tile([0, 0, -1.0], (len(faces), 1)),
        )
        return fcvm_tpu.Model(
            mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads, name="col"
        )

    params = ControlParams(
        sig_yield=1e5, nstep=3, error_max=1e-10, et_e=0.0, target_lf=1e9,
        gnl="GNLY", max_imp=0.05, ev1=1.0, ev2=0.0,
    )

    reference = _run(build(), params, 0)  # local, unpatched

    real = bk.pencil_subspace
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:  # the sharded SPMD attempt
            raise bk.EigensolveBreakdownError("forced breakdown (test)")
        return real(*args, **kwargs)

    monkeypatch.setattr(bk, "pencil_subspace", flaky)
    with pytest.warns(UserWarning, match="escalating"):
        sharded = _run(build(), params, 8)
    assert calls["n"] >= 2  # the fallback actually ran an eigensolve
    np.testing.assert_allclose(
        reference.eigenvalues, sharded.eigenvalues, rtol=1e-8
    )
    np.testing.assert_allclose(reference.history.lbd, sharded.history.lbd,
                               atol=1e-9)


def test_sharded_buckling_honors_penalty_bc():
    """config.buckling_bc='penalty' (the reference-parity x100 diagonal
    pencil) must not be silently ignored by the sharded backend: its
    buckling() routes to the local penalty implementation, so factors
    match the local penalty run exactly."""
    l = 10.0

    def build():
        mesh = meshgen.box_tet10(2, 2, 8, 1.0, 1.0, l * 2)
        bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
            [(mesh.select_nodes(lambda x, y, z: z < 1e-9), (0.0, 0.0, 0.0))]
        )
        faces = mesh.faces_on(lambda x, y, z: z > 2 * l - 1e-9)
        loads = fcvm_tpu.Loads(
            traction_faces=faces,
            tractions=np.tile([0, 0, -1.0], (len(faces), 1)),
        )
        return fcvm_tpu.Model(
            mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads, name="col"
        )

    params = ControlParams(
        sig_yield=1e5, nstep=3, error_max=1e-10, et_e=0.0, target_lf=1e9,
        gnl="GNLY", max_imp=0.05, ev1=1.0, ev2=0.0,
    )
    cfg = get_config()
    old_bc = cfg.buckling_bc
    cfg.buckling_bc = "penalty"
    try:
        r_local = _run(build(), params, 0)
        r_shard = _run(build(), params, 8)
    finally:
        cfg.buckling_bc = old_bc
    np.testing.assert_allclose(
        r_local.eigenvalues, r_shard.eigenvalues, rtol=1e-10
    )
    np.testing.assert_allclose(r_local.history.lbd, r_shard.history.lbd,
                               atol=1e-9)


def test_sharded_refinement_tier_converges_below_f32_floor():
    """The mixed-precision refinement tier over the SHARDED backend: f64
    residual evaluation inside shard_map (f64 psum reduce) with the f32
    operator, converging an 8-device f32 run to an error_max below the f32
    floor without the f64 rerun."""
    cfg = get_config()
    model = _box_model(n=2)
    params = ControlParams(
        sig_yield=240.0, nstep=3, error_max=1e-9, et_e=0.1,
        target_lf=99.0, iterat_max=25,
    )
    old_dtype, old_n = cfg.dtype, cfg.n_devices
    cfg.dtype = "float32"
    cfg.n_devices = 8
    lines = []
    try:
        res = fcvm_tpu.solve_collapse(model, params, progress=lines.append)
    finally:
        cfg.dtype, cfg.n_devices = old_dtype, old_n
    assert any("f64 residual refinement" in l for l in lines)
    assert res.cg_stats["refinement_activations"] >= 1
    assert len(res.history.lbd) == 4  # all steps completed in-run
    assert not any(l.startswith("PRECISION FAILOVER") for l in lines)
    # genuinely converged below the f32 floor on every step
    import re

    errs = [float(m.group(1)) for m in
            (re.search(r"Error: ([0-9.e+-]+)", l) for l in lines) if m]
    assert min(errs) <= params.error_max
