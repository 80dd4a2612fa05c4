"""Driver-level A/B of the predictor load-space recycling on device.

tools/gnl_refresh_probe.py showed the warm-started GNL predictor solve gains
nothing from the load-harvested deflation space (21 iters both ways, plus
re-Galerkin/W traffic).  That probe isolated ONE refresh; this script runs
the FULL production collapse driver (GNLY, plastic regime, 499k dof default)
with ``config.load_deflation`` on vs off and reports end-to-end wall time,
per-phase timers and predictor iteration totals, alternating runs to cancel
cache/thermal drift.

Run on the GPU from the repo root:
    timeout 3600 python tools/load_defl_ab.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fcvm_tpu.config import enable_compilation_cache, get_config

enable_compilation_cache()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


NX = int(os.environ.get("FCVM_BENCH_NX", "27"))  # ~499k dof
NSTEP = int(os.environ.get("AB_NSTEP", "10"))


def build(nx):
    import fcvm_tpu
    from fcvm_tpu.models import meshgen

    lbox = 10.0
    mesh = meshgen.box_tet10(nx, nx, nx, lbox, lbox, lbox)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        ]
    )
    faces = mesh.faces_on(lambda x, y, z: x > lbox - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces,
        tractions=np.tile([100.0, 0, 0], (len(faces), 1)),
    )
    return mesh, fcvm_tpu.Model(
        mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads
    )


def run_once(model, params, ldefl):
    import fcvm_tpu

    cfg = get_config()
    cfg.load_deflation = ldefl
    t0 = time.perf_counter()
    res = fcvm_tpu.solve_collapse(model, params)
    wall = time.perf_counter() - t0
    s = res.cg_stats
    return {
        "wall": wall,
        "lbd": float(res.history.lbd[-1]),
        "peeq": float(np.asarray(res.peeq_gp).max()),
        "solves": s["solves"],
        "iters": s["iters"],
        "cg_time": s["time"],
        "tangent_time": s["tangent_time"],
        "pred_solves": s.get("predictor_solves", 0),
        "pred_iters": s.get("predictor_iters", 0),
    }


def main():
    import fcvm_tpu

    mesh, model = build(NX)
    log(f"mesh: ndof={mesh.ndof}")
    # plastic GNL collapse: yield low enough that most steps carry plastic
    # Gauss points (every step then pays a tangent refresh + predictor)
    params = fcvm_tpu.ControlParams(
        sig_yield=60.0, nstep=NSTEP, error_max=1e-5, et_e=0.1,
        target_lf=99.0, gnl="GNLY", max_imp=0.0,
    )
    # warm both executables, then alternate off/on/off/on
    log("warmup (ldefl=on, compile+cache)...")
    run_once(model, params, True)
    results = {True: [], False: []}
    for ldefl in (False, True, False, True):
        r = run_once(model, params, ldefl)
        results[ldefl].append(r)
        log(f"ldefl={'on' if ldefl else 'off':3s} wall={r['wall']:.1f}s "
            f"cg={r['cg_time']:.1f}s tangent={r['tangent_time']:.1f}s "
            f"iters={r['iters']} pred={r['pred_iters']}/{r['pred_solves']} "
            f"lbd={r['lbd']:.6f} peeq={r['peeq']:.3e}")
    for ldefl in (False, True):
        w = min(r["wall"] for r in results[ldefl])
        log(f"ldefl={'on' if ldefl else 'off'}: best wall {w:.1f}s")
    assert abs(results[True][0]["lbd"] - results[False][0]["lbd"]) < 1e-4


if __name__ == "__main__":
    main()
