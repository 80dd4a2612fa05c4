"""Command-line front end: ``python -m fcvm_tpu <command> case.toml``.

The batch equivalent of the reference workbench's Start / Save / Sum buttons
(``InitGui.py:141-145``):

  run     full collapse analysis -> .out, .vtk, .png (the Start button)
  buckle  linear buckling factors + mode shapes
  info    parse + validate a case, print the model summary
  bench   quick per-step timing of the case on the current backend
  sum     post-hoc surface/edge averages from a finished run's .vtk
          (the Sum button; reads [[sum.*]] groups from the case file)
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fcvm_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "buckle", "info", "bench", "sum"):
        p = sub.add_parser(name)
        p.add_argument("case", help="TOML case file or FreeCAD .FCStd document")
        p.add_argument(
            "--inp",
            default=None,
            help=".inp control file overriding the document's paired one "
            "(FCStd input only)",
        )
        p.add_argument(
            "--mesh",
            default=None,
            help="external mesh file (UNV/Gmsh/VTK) replacing the "
            "document's embedded mesh (FCStd input only)",
        )
        p.add_argument("--outdir", default="out")
        p.add_argument("--x64", action="store_true", help="enable float64")
        p.add_argument("--cpu", action="store_true", help="force CPU backend")
        p.add_argument("--checkpoint", action="store_true")
        p.add_argument(
            "--resume", default=None, metavar="DIR",
            help="resume from the latest step checkpoint in DIR "
            "(written by a previous --checkpoint run)",
        )
        p.add_argument("--steps", type=int, default=0, help="override nstep")
        p.add_argument(
            "--devices", type=int, default=0,
            help="shard the solve over N devices (element-partition SPMD; "
            "0 = single device)",
        )
        p.add_argument(
            "--gif", action="store_true",
            help="also write the orbital clip-view GIF",
        )
        p.add_argument(
            "--distributed", action="store_true",
            help="multi-host SPMD: call jax.distributed.initialize() so the "
            "device mesh spans every process (launch the same command on "
            "each host, e.g. one process per GPU host)",
        )
        p.add_argument(
            "--coordinator", default=None, metavar="HOST:PORT",
            help="with --distributed: coordinator address, e.g. "
            "localhost:1234 on one host (also needs --num-processes / "
            "--process-id; GPU hosts do not auto-detect a cluster)",
        )
        p.add_argument("--num-processes", type=int, default=None)
        p.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.x64:
        jax.config.update("jax_enable_x64", True)

    if args.distributed:
        # Platform config above must precede backend/distributed init.
        kw = {}
        if args.coordinator is not None:
            kw = dict(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id,
                cluster_detection_method="deactivate",
            )
        jax.distributed.initialize(**kw)

    import fcvm_tpu
    from fcvm_tpu.models.casefile import load_case

    if str(args.case).lower().endswith(".fcstd"):
        # Golden-corpus replay: FreeCAD document + its paired .inp control
        # file, the reference's own input pairing (fcVM.py:74-76).
        from fcvm_tpu.models.fcstd import load_reference_case

        model, params = load_reference_case(
            args.case, inp_path=args.inp, mesh_path=args.mesh
        )
    else:
        model, params = load_case(args.case)
    if args.steps:
        params.nstep = args.steps
    if args.devices:
        fcvm_tpu.get_config().n_devices = args.devices
    elif args.distributed:
        # multi-host default: shard over every device of the global mesh
        fcvm_tpu.get_config().n_devices = jax.device_count()

    if args.cmd == "info":
        m = model.mesh
        fixmask, u_fix, movdof = model.bcs.masks(m.ndof)
        print(f"model: {model.name}")
        print(f"nodes: {m.n_nodes}  elements: {m.n_elements}  ndof: {m.ndof}")
        print(f"material: E={model.material.e} nu={model.material.nu} "
              f"rho={model.material.density}")
        print(f"fixed dofs: {int((fixmask < 0.5).sum())}  "
              f"driven dofs: {int(movdof.sum())}")
        print(f"loads: {len(model.loads.pressure_faces)} pressure faces, "
              f"{len(model.loads.traction_faces)} traction faces, "
              f"{len(model.loads.vertices)} point loads, "
              f"gravity {model.loads.gravity.tolist()}")
        print(f"control: nstep={params.nstep} gnl={params.gnl} "
              f"sig_yield={params.sig_yield} target_LF={params.target_lf}")
        return 0

    if args.cmd == "buckle":
        lam, vecs = fcvm_tpu.linear_buckling(model, params, k=2)
        print("buckling load factors:", lam)
        return 0

    if args.cmd == "run":
        # under --distributed every process solves; only rank 0 narrates
        say = print if jax.process_index() == 0 else (lambda *a, **k: None)
        res = fcvm_tpu.run_analysis(
            model, params, outdir=args.outdir,
            checkpoint=args.checkpoint, resume_from=args.resume,
            progress=say,
        )
        h = res.history
        say(f"final load level: {h.lbd[-1]:.5f}  max |u|: {max(h.un):.5e}  "
            f"PEEQ max: {h.peeqmax[-1]:.4e}  CSR max: {h.csr[-1]:.4e}")
        if args.gif and jax.process_index() == 0:
            from fcvm_tpu.runtime.viz import save_orbit_gif
            from fcvm_tpu.runtime.vtk import _elements_per_node
            from fcvm_tpu.ops import postproc

            noce = _elements_per_node(model.mesh.elnodes, model.mesh.n_nodes)
            _, _, csr_n, _, _ = postproc.map_stresses(
                params.averaged_option == "averaged", model.mesh.elnodes,
                model.mesh.n_nodes, res.sig_gp, res.peeq_gp, res.csr_gp,
                res.svm_gp, noce, params.sig_yield,
            )
            save_orbit_gif(
                f"{args.outdir}/{model.name}_orbit.gif",
                __import__("numpy").asarray(res.coords),
                model.mesh.elnodes, csr_n,
            )
        say(f"wrote {args.outdir}/{model.name}.out .vtk .png")
        from fcvm_tpu.models.casefile import parse_sum_groups

        if str(args.case).lower().endswith(".fcstd"):
            edge_groups, face_groups = {}, {}
        else:
            edge_groups, face_groups = parse_sum_groups(args.case, model.mesh)
        if (edge_groups or face_groups) and jax.process_index() == 0:
            fcvm_tpu.run_sum(
                model, res, params, edge_groups, face_groups, outdir=args.outdir
            )
            say(f"wrote {args.outdir}/{model.name}.avr")
        return 0

    if args.cmd == "sum":
        # Post-hoc Sum (fcVM_sum.FCMacro): the reference reads CSR/PEEQ/
        # von Mises from the stored result object of a finished analysis;
        # we read them back from the run's exported .vtk.
        from pathlib import Path

        from fcvm_tpu.models.casefile import parse_sum_groups
        from fcvm_tpu.models.meshio_io import read_vtk
        from fcvm_tpu.ops import postproc
        from fcvm_tpu.runtime import report as report_mod
        from fcvm_tpu.runtime.vtk import read_point_fields

        if str(args.case).lower().endswith(".fcstd"):
            print("sum needs a TOML case file with [[sum.edge]]/[[sum.face]] "
                  "groups", file=sys.stderr)
            return 2
        edge_groups, face_groups = parse_sum_groups(args.case, model.mesh)
        if not (edge_groups or face_groups):
            print("no [[sum.edge]]/[[sum.face]] groups in the case file",
                  file=sys.stderr)
            return 2
        vtk_path = Path(args.outdir) / f"{model.name}.vtk"
        if not vtk_path.exists():
            print(f"{vtk_path} not found — run the analysis first",
                  file=sys.stderr)
            return 2
        fields = read_point_fields(vtk_path)
        peeq = fields["Equivalent_Plastic_Strain"]
        csr = fields["Critical_Strain_Ratio"]
        svm = fields["von_Mises_Stress"]
        coords = read_vtk(vtk_path).coords  # run-time (possibly seeded) coords
        e_names, f_names = list(edge_groups), list(face_groups)
        e_len, (e_peeq, e_csr, e_svm) = postproc.integrate_edges(
            [edge_groups[k] for k in e_names], coords, peeq, csr, svm
        )
        f_area, (f_peeq, f_csr, f_svm) = postproc.integrate_faces(
            [face_groups[k] for k in f_names], coords, peeq, csr, svm
        )
        report_mod.write_avr(
            vtk_path.with_suffix(".avr"), model.name,
            e_names, e_len, e_peeq, e_csr, e_svm,
            f_names, f_area, f_peeq, f_csr, f_svm,
        )
        print(f"wrote {vtk_path.with_suffix('.avr')}")
        return 0

    if args.cmd == "bench":
        t0 = time.time()
        res = fcvm_tpu.solve_collapse(model, params)
        dt = time.time() - t0
        nsteps = max(len(res.history.lbd) - 1, 1)
        print(json.dumps({
            "metric": "case_step_wall_ms",
            "value": round(dt / nsteps * 1e3, 2),
            "unit": "ms",
            "steps": nsteps,
            "cg_solves": res.cg_stats["solves"],
            "cg_iters": res.cg_stats["iters"],
        }))
        return 0


if __name__ == "__main__":
    sys.exit(main())
