"""Cost/benefit of the mixed-precision refinement tier on device.

Three production-driver runs on the 27.8k-dof bench box (plastic GNL
collapse, 5 steps past yield):

  A. f32 @ error_max 1e-5  — the normal tier, no governance events
  B. f32 @ error_max 3e-9  — far below the f32 floor (~2e-7 relative):
     the watch escalates and the REFINEMENT tier converges in-run
  C. f64 @ error_max 3e-9  — what the pre-refinement failover would have
     paid (the whole analysis in f64)

Plus the imperfect-column example at stock config as a regression row
(it self-governs via the clamp; refinement must not disturb it).

Prints one JSON line per row to stdout; diagnostics to stderr.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fcvm_tpu.config import enable_compilation_cache, get_config

enable_compilation_cache()

import jax

import bench
import fcvm_tpu


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_row(label, model, params, dtype=None):
    cfg = get_config()
    old_dtype = cfg.dtype
    x64_old = jax.config.read("jax_enable_x64")
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
        cfg.dtype = "float64"
    elif dtype == "float32":
        cfg.dtype = "float32"
    t0 = time.perf_counter()
    try:
        res = fcvm_tpu.solve_collapse(model, params)
    finally:
        cfg.dtype = old_dtype
        if jax.config.read("jax_enable_x64") != x64_old:
            jax.config.update("jax_enable_x64", x64_old)
    wall = time.perf_counter() - t0
    nsteps = max(len(res.history.lbd) - 1, 1)
    row = {
        "row": label,
        "steps": nsteps,
        "wall_s": round(wall, 2),
        "stepping_s": round(res.timers.get("stepping", 0.0), 2),
        "step_ms": round(res.timers.get("stepping", 0.0) / nsteps * 1e3, 1),
        "newton_iters": res.cg_stats.get("newton_iterations"),
        "cg_iters": res.cg_stats.get("iters"),
        "refinements": res.cg_stats.get("refinement_activations"),
        "refined_from_step": res.cg_stats.get("refined_from_step"),
        "clamps": res.cg_stats.get("floor_clamps"),
        "lbd_final": round(float(res.history.lbd[-1]), 6),
        "peeq_max": float(np.max(res.peeq_gp)),
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    nx = int(os.environ.get("FCVM_BENCH_NX_CPU", "10"))
    _, model = bench.build(nx)
    base = fcvm_tpu.ControlParams(
        sig_yield=60.0, nstep=5, et_e=0.1, target_lf=99.0, gnl="GNLY",
        max_imp=0.0, iterat_max=25,
    )
    run_row("A f32 @1e-5", model,
            dataclasses.replace(base, error_max=1e-5), dtype="float32")
    run_row("B f32+refine @3e-9", model,
            dataclasses.replace(base, error_max=3e-9), dtype="float32")
    run_row("C f64 @3e-9", model,
            dataclasses.replace(base, error_max=3e-9), dtype="float64")

    if os.environ.get("FCVM_REFINE_PROBE_EXAMPLE", "1") not in ("0", "off"):
        from fcvm_tpu.models.casefile import load_case

        model_e, params_e = load_case("examples/imperfect_column_collapse.toml")
        run_row("D imperfect column stock", model_e, params_e,
                dtype="float32")


if __name__ == "__main__":
    main()
