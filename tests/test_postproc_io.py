"""Post-processing, report writers, VTK export, .inp roundtrip."""

import numpy as np
import pytest

import fcvm_tpu
from fcvm_tpu.models import meshgen
from fcvm_tpu.models.inp import ControlParams, read_inp, write_inp
from fcvm_tpu.ops import postproc

E, NU, SY0, L, SIGMA = 210000.0, 0.3, 240.0, 10.0, 100.0


@pytest.fixture(scope="module")
def solved():
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        ]
    )
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces, tractions=np.tile([SIGMA, 0, 0], (len(faces), 1))
    )
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads, name="uniax")
    params = fcvm_tpu.ControlParams(
        sig_yield=SY0, nstep=8, error_max=1e-9, et_e=0.1, target_lf=2.6,
        ultimate_strain=0.25,
    )
    cont = lambda h, i: "add" if abs(h.lbd[-1] - 2.6) > 1e-9 else "stop"
    res = fcvm_tpu.solve_collapse(model, params, continuation=cont)
    return mesh, model, params, res


def test_map_stresses_uniform_field(solved):
    mesh, model, params, res = solved
    noce = mesh.elements_per_node()
    for averaged in (True, False):
        stress, peeq, csr, svm, triax = postproc.map_stresses(
            averaged, mesh.elnodes, mesh.n_nodes, res.sig_gp, res.peeq_gp,
            res.csr_gp, res.svm_gp, noce, params.sig_yield,
        )
        # homogeneous uniaxial state: every node sees sigma_xx = 260 MPa
        sxx = res.sig_gp[..., 0].mean()
        np.testing.assert_allclose(stress[:, 0], sxx, rtol=1e-8)
        np.testing.assert_allclose(stress[:, 1:], 0.0, atol=1e-6)
        np.testing.assert_allclose(svm, res.svm_gp.mean(), rtol=1e-8)
        np.testing.assert_allclose(peeq, res.peeq_gp.mean(), rtol=1e-7)
        np.testing.assert_allclose(triax, sxx / 3.0 / params.sig_yield, rtol=1e-8)


def test_principal_stresses():
    stress = np.array([[100.0, -40.0, 10.0, 0.0, 0.0, 0.0],
                       [0.0, 0.0, 0.0, 50.0, 0.0, 0.0]])
    s1, s2, s3, v1, v2, v3 = postproc.principal_stresses(stress)
    np.testing.assert_allclose([s1[0], s2[0], s3[0]], [100.0, 10.0, -40.0])
    # pure shear sxy: principals +-50, 0
    np.testing.assert_allclose([s1[1], s2[1], s3[1]], [50.0, 0.0, -50.0], atol=1e-9)
    np.testing.assert_allclose(np.linalg.norm(v1[0]), 100.0)


def test_integrate_edges_faces_constant_field(solved):
    mesh, model, params, res = solved
    ones = np.ones(mesh.n_nodes)
    lin = mesh.coords[:, 0].copy()  # linear in x
    # edge along x at y=0, z=0
    nid = {tuple(np.round(c, 9)): i for i, c in enumerate(mesh.coords)}
    edges = []
    for i in range(2):
        a, b = i * L / 2, (i + 1) * L / 2
        edges.append([nid[(a, 0.0, 0.0)], nid[(b, 0.0, 0.0)], nid[((a + b) / 2, 0.0, 0.0)]])
    lengths, (avg1, avg2) = postproc.integrate_edges([np.array(edges)], mesh.coords, ones, lin)
    np.testing.assert_allclose(lengths, [L], rtol=1e-12)
    np.testing.assert_allclose(avg1, [1.0], rtol=1e-12)
    np.testing.assert_allclose(avg2, [L / 2], rtol=1e-12)  # mean of linear field

    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    areas, (favg,) = postproc.integrate_faces([faces], mesh.coords, ones)
    np.testing.assert_allclose(areas, [L * L], rtol=1e-12)
    np.testing.assert_allclose(favg, [1.0], rtol=1e-12)


def test_reinforcement_rho_uniaxial_tension():
    fy = 435.0
    stress = np.array([[100.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    rho = postproc.reinforcement_rho(stress, fy)
    np.testing.assert_allclose(rho[0], [100.0 / fy, 0.0, 0.0], atol=1e-12)
    # pure hydrostatic compression requires no reinforcement
    stress = np.array([[-10.0, -10.0, -10.0, 0.0, 0.0, 0.0]])
    rho = postproc.reinforcement_rho(stress, fy)
    np.testing.assert_allclose(rho[0], 0.0, atol=1e-12)


def test_mohr_coulomb():
    mc = postproc.mohr_coulomb(np.array([0.0]), np.array([-30.0]), 0.0, 30.0)
    np.testing.assert_allclose(mc, [0.0])  # exactly at the criterion
    mc = postproc.mohr_coulomb(np.array([10.0]), np.array([-30.0]), 0.0, 30.0)
    np.testing.assert_allclose(mc, [10.0])


def test_out_report_structure(tmp_path, solved):
    mesh, model, params, res = solved
    from fcvm_tpu.runtime.report import write_out

    p = tmp_path / "uniax.out"
    write_out(p, model.name, res, params, mesh.n_elements, mesh.n_nodes)
    text = p.read_text()
    assert "model name:" in text and "uniax" in text
    assert "No. of elements:{0: >45}".format(mesh.n_elements) in text
    assert "analysis type: elastic-plastic, geometric linear" in text
    assert "Sum of loads x-direction:" in text
    assert "csr_max" in text
    # one history row per recorded step
    rows = [ln for ln in text.splitlines() if ln.strip() and ln.lstrip()[0].isdigit()]
    assert len(rows) == len(res.history.crip)


def test_avr_report_structure(tmp_path, solved):
    mesh, model, params, res = solved
    nid = {tuple(np.round(c, 9)): i for i, c in enumerate(mesh.coords)}
    edges = []
    for i in range(2):
        a, b = i * L / 2, (i + 1) * L / 2
        edges.append([nid[(a, 0.0, 0.0)], nid[(b, 0.0, 0.0)], nid[((a + b) / 2, 0.0, 0.0)]])
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    out = fcvm_tpu.run_sum(
        model, res, params,
        edge_groups={"Edge1": np.array(edges)},
        face_groups={"Face1": faces},
        outdir=str(tmp_path),
    )
    np.testing.assert_allclose(out["edges"]["Edge1"]["length"], L, rtol=1e-9)
    np.testing.assert_allclose(out["faces"]["Face1"]["area"], L * L, rtol=1e-9)
    np.testing.assert_allclose(out["faces"]["Face1"]["svm"], res.svm_gp.mean(), rtol=1e-6)
    text = (tmp_path / "uniax.avr").read_text()
    assert "average values" in text
    assert "Edge1" in text and "Face1" in text


def test_vtk_export(tmp_path, solved):
    mesh, model, params, res = solved
    from fcvm_tpu.runtime.vtk import export_results

    p = tmp_path / "uniax.vtk"
    data = export_results(p, res, mesh.elnodes, params, params.sig_yield, include_rho=True)
    text = p.read_text()
    assert f"POINTS {mesh.n_nodes} double" in text
    assert f"CELL_TYPES {mesh.n_elements}" in text
    assert "VECTORS Displacement double" in text
    assert "von_Mises_Stress 1" in text
    assert "Stress_Tensor 6" in text
    assert "Reinforcement_Ratio_x" in text
    assert data["von Mises Stress"].shape == (mesh.n_nodes,)
    # all cells declared quadratic tetra
    assert text.count("\n24") >= mesh.n_elements - 1


def test_run_analysis_pipeline(tmp_path):
    mesh = meshgen.box_tet10(1, 1, 1, L, L, L)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))]
    )
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces, tractions=np.tile([50.0, 0, 0], (len(faces), 1))
    )
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads, name="pipe")
    params = fcvm_tpu.ControlParams(sig_yield=SY0, nstep=3, error_max=1e-8, target_lf=1.0)
    res = fcvm_tpu.run_analysis(model, params, outdir=str(tmp_path))
    assert (tmp_path / "pipe.out").exists()
    assert (tmp_path / "pipe.vtk").exists()
    assert (tmp_path / "pipe.png").exists()
    assert not res.fail


def test_run_analysis_without_matplotlib_skips_plots(tmp_path, monkeypatch):
    """Without matplotlib the results are still written; the plots are
    skipped with one line, and the run goes on."""
    import importlib.util

    real_find_spec = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "matplotlib"
        else real_find_spec(name, *a),
    )
    mesh = meshgen.box_tet10(1, 1, 1, L, L, L)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))]
    )
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces, tractions=np.tile([50.0, 0, 0], (len(faces), 1))
    )
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads,
                           name="noplot")
    params = fcvm_tpu.ControlParams(sig_yield=SY0, nstep=2, error_max=1e-8,
                                    target_lf=1.0)
    lines = []
    res = fcvm_tpu.run_analysis(model, params, outdir=str(tmp_path),
                                progress=lines.append)
    assert (tmp_path / "noplot.out").exists()
    assert (tmp_path / "noplot.vtk").exists()
    assert not (tmp_path / "noplot.png").exists()
    assert lines.count("plots skipped: matplotlib is not installed") == 1
    assert not res.fail


def test_inp_roundtrip(tmp_path):
    p = ControlParams(sig_yield=100.0, nstep=10, error_max=5e-3, et_e=0.0,
                      target_lf=1.5, gnl="GNLN", max_imp=10.0, ev1=1.0, ev2=0.0)
    f = tmp_path / "m.inp"
    write_inp(p, f)
    q = read_inp(f)
    assert q == p


def test_reads_reference_corpus():
    """Every bundled reference control file parses losslessly."""
    import pathlib

    ref = pathlib.Path("/root/reference/control files")
    if not ref.is_dir():
        pytest.skip("reference corpus not mounted")
    files = sorted(ref.glob("*.inp"))
    assert len(files) > 90
    full = 0
    for f in files:
        p = read_inp(f)
        assert p.nstep >= 1
        assert p.gnl in ("GNLY", "GNLN")
        assert p.disp_output in ("total", "incremental")
        if len(f.read_text().splitlines()) >= 21:
            full += 1
            assert p.ev1 >= 0.0
    assert full > 55  # the current-format majority of the corpus


def _rho_scalar_reference(s, fy):
    """Scalar per-node transcription of the HERON 53-4 candidate scan
    (fcVM.py:2997-3150) used as the oracle for the batched implementation."""
    sxx, syy, szz, sxy, sxz, syz = s
    rhox, rhoy, rhoz = np.zeros(15), np.zeros(15), np.zeros(15)
    i3 = (sxx * syy * szz + 2 * sxy * sxz * syz
          - sxx * syz**2 - syy * sxz**2 - szz * sxy**2)
    d = sxx * syy - sxy**2
    if d != 0.0:
        rhoz[0] = i3 / d / fy
    d = sxx * szz - sxz**2
    if d != 0.0:
        rhoy[1] = i3 / d / fy
    d = syy * szz - syz**2
    if d != 0.0:
        rhox[2] = i3 / d / fy
    if sxx != 0.0:
        fc = sxz * sxy / sxx - syz
        rhoy[3] = (syy - sxy**2 / sxx + fc) / fy
        rhoz[3] = (szz - sxz**2 / sxx + fc) / fy
        rhoy[4] = (syy - sxy**2 / sxx - fc) / fy
        rhoz[4] = (szz - sxz**2 / sxx - fc) / fy
    if syy != 0.0:
        fc = syz * sxy / syy - sxz
        rhox[5] = (sxx - sxy**2 / syy + fc) / fy
        rhoz[5] = (szz - syz**2 / syy + fc) / fy
        rhox[6] = (sxx - sxy**2 / syy - fc) / fy
        rhoz[6] = (szz - syz**2 / syy - fc) / fy
    if szz != 0.0:
        fc = sxz * syz / szz - sxy
        rhox[7] = (sxx - sxz**2 / szz + fc) / fy
        rhoy[7] = (syy - syz**2 / szz + fc) / fy
        rhox[8] = (sxx - sxz**2 / szz - fc) / fy
        rhoy[8] = (syy - syz**2 / szz - fc) / fy
    rhox[9], rhoy[9], rhoz[9] = (sxx + sxy + sxz) / fy, (syy + sxy + syz) / fy, (szz + sxz + syz) / fy
    rhox[10], rhoy[10], rhoz[10] = (sxx + sxy - sxz) / fy, (syy + sxy - syz) / fy, (szz - sxz - syz) / fy
    rhox[11], rhoy[11], rhoz[11] = (sxx - sxy - sxz) / fy, (syy - sxy + syz) / fy, (szz - sxz + syz) / fy
    rhox[12], rhoy[12], rhoz[12] = (sxx - sxy + sxz) / fy, (syy - sxy - syz) / fy, (szz + sxz - syz) / fy
    if syz != 0.0:
        rhox[13] = (sxx - sxy * sxz / syz) / fy
    if sxz != 0.0:
        rhoy[13] = (syy - sxy * syz / sxz) / fy
    if sxy != 0.0:
        rhoz[13] = (szz - sxz * syz / sxy) / fy
    rmin, eqmin = 1.0e9, 14
    for ir in range(15):
        if rhox[ir] >= -1e-10 and rhoy[ir] >= -1e-10 and rhoz[ir] > -1e-10:
            scxx, scyy, sczz = sxx - rhox[ir] * fy, syy - rhoy[ir] * fy, szz - rhoz[ir] * fy
            ic1 = scxx + scyy + sczz
            ic2 = scxx * scyy + scyy * sczz + sczz * scxx - sxy**2 - sxz**2 - syz**2
            ic3 = (scxx * scyy * sczz + 2 * sxy * sxz * syz
                   - scxx * syz**2 - scyy * sxz**2 - sczz * sxy**2)
            if ic1 <= 1e-6 and ic2 >= -1e-6 and ic3 <= 1e-6:
                rsum = rhox[ir] + rhoy[ir] + rhoz[ir]
                if 0.0 < rsum < rmin:
                    rmin, eqmin = rsum, ir
    return np.array([rhox[eqmin], rhoy[eqmin], rhoz[eqmin]])


def test_reinforcement_rho_matches_scalar_scan():
    rng = np.random.default_rng(42)
    fy = 435.0
    # general random states, pure-shear, axis-aligned, sparse-component and
    # zero-row corner cases
    states = [rng.normal(scale=50.0, size=6) for _ in range(200)]
    states += [np.array([0.0, 0.0, 0.0, 30.0, 0.0, 0.0]),
               np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0]),
               np.array([50.0, -20.0, 0.0, 0.0, 0.0, 0.0]),
               np.array([0.0, 0.0, 10.0, 0.0, 5.0, 0.0])]
    for i in range(30):  # random sparsity patterns
        v = rng.normal(scale=50.0, size=6)
        v[rng.random(6) < 0.5] = 0.0
        states.append(v)
    stress = np.stack(states)
    got = postproc.reinforcement_rho(stress, fy)
    want = np.stack([_rho_scalar_reference(s, fy) for s in stress])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
