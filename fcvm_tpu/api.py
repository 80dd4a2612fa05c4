"""High-level analysis pipeline: the reference's macro driver, CAD-free.

``run_analysis`` chains the full Start-button pipeline
(``source code/fcVM.FCMacro:100-257``): solve -> map stresses -> write the
``.out`` report -> export VTK -> save curves, with per-phase wall timers.
``run_sum`` is the "Sum" button (``fcVM_sum.FCMacro``): integrate nodal
fields over named edge/face groups into a ``.avr`` report.
"""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path
from typing import Optional


from fcvm_tpu.models.inp import ControlParams
from fcvm_tpu.models.spec import Model
from fcvm_tpu.ops import postproc
from fcvm_tpu.runtime import report as report_mod
from fcvm_tpu.runtime import vtk as vtk_mod
from fcvm_tpu.runtime.driver import AnalysisResults, solve_collapse


def run_analysis(
    model: Model,
    params: ControlParams,
    outdir: Optional[str] = None,
    continuation=None,
    checkpoint: bool = False,
    resume_from: Optional[str] = None,
    progress=None,
    monitor=None,
    save_plots: bool = True,
) -> AnalysisResults:
    """Full pipeline; writes ``<name>.out``, ``<name>.vtk``, ``<name>.png``
    into ``outdir`` when given."""
    log = progress or (lambda s: None)
    t = {}

    t0 = time.time()
    res = solve_collapse(
        model,
        params,
        continuation=continuation,
        checkpoint_path=(str(Path(outdir) / "checkpoints") if (checkpoint and outdir) else None),
        resume_from=resume_from,
        progress=progress,
        monitor=monitor,
    )
    t["solve"] = time.time() - t0

    # Under a multi-host jax.distributed launch every process runs the same
    # SPMD program; file outputs are written once, by process 0.
    import jax

    if outdir is not None and jax.process_index() == 0:
        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        report_mod.write_out(
            out / f"{model.name}.out", model.name, res, params,
            model.mesh.n_elements, model.mesh.n_nodes,
        )
        t["report"] = time.time() - t0
        t0 = time.time()
        vtk_mod.export_results(
            out / f"{model.name}.vtk", res, model.mesh.elnodes, params,
            params.sig_yield,
        )
        t["vtk"] = time.time() - t0
        if save_plots and importlib.util.find_spec("matplotlib") is None:
            # the plots are an optional extra (pyproject "viz"); the
            # .out/.vtk results above are complete without them
            (progress or print)("plots skipped: matplotlib is not installed")
        elif save_plots:
            from fcvm_tpu.runtime.plots import save_curves
            from fcvm_tpu.runtime.viz import save_result_views

            t0 = time.time()
            save_curves(out / f"{model.name}.png", res.history, params)
            # headless clip-plane + principal-stress viewer bundle
            # (the reference's interactive pyvista panes, fcVM.py:1691-1989)
            save_result_views(out, model.name, model, res, params)
            t["plots"] = time.time() - t0

    for k, v in {**res.timers, **t}.items():
        log(f"{k + '.':.<64} {v:7.3f} seconds")
    return res


def run_sum(
    model: Model,
    results: AnalysisResults,
    params: ControlParams,
    edge_groups: dict,
    face_groups: dict,
    outdir: Optional[str] = None,
):
    """Integrate PEEQ/CSR/svm averages over named edge/face element groups
    and (optionally) write the ``.avr`` report.

    Args:
      edge_groups: ``name -> (n, 3) line3 node ids``.
      face_groups: ``name -> (n, 6) tri6 node ids``.
    """
    mesh = model.mesh
    noce = mesh.elements_per_node()
    _, peeq, csr, svm, _ = postproc.map_stresses(
        params.averaged_option == "averaged", mesh.elnodes, mesh.n_nodes,
        results.sig_gp, results.peeq_gp, results.csr_gp, results.svm_gp,
        noce, params.sig_yield,
    )
    coords = results.coords
    e_names = list(edge_groups)
    f_names = list(face_groups)
    e_len, (e_peeq, e_csr, e_svm) = postproc.integrate_edges(
        [edge_groups[k] for k in e_names], coords, peeq, csr, svm
    )
    f_area, (f_peeq, f_csr, f_svm) = postproc.integrate_faces(
        [face_groups[k] for k in f_names], coords, peeq, csr, svm
    )
    if outdir is not None:
        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        report_mod.write_avr(
            out / f"{model.name}.avr", model.name,
            e_names, e_len, e_peeq, e_csr, e_svm,
            f_names, f_area, f_peeq, f_csr, f_svm,
        )
    return {
        "edges": {k: dict(length=e_len[i], peeq=e_peeq[i], csr=e_csr[i], svm=e_svm[i]) for i, k in enumerate(e_names)},
        "faces": {k: dict(area=f_area[i], peeq=f_peeq[i], csr=f_csr[i], svm=f_svm[i]) for i, k in enumerate(f_names)},
    }
