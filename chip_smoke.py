"""Smoke run of the collapse solver on an NVIDIA GPU.

Drives the production path once through the public entry points and checks
every phase against a plain reference:

  device        the default JAX backend is a GPU (exit 2 otherwise)
  closed_form   f64 uniaxial-tension box vs the 1D radial-return recursion
  matched_size  28.6k-dof plate with a hole: f32 CG tier on the GPU vs the
                f64 scipy direct tier on the CPU
  full_size     502,599-dof plate through ``run_analysis`` in f32, the same
                steps in f64, and one timed CG iteration / operator matvec
  buckling      ``examples/euler_column.toml`` vs the Euler load

Each phase prints one JSON line (wall time, compile time, the card's name
and power limit); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed phase makes the exit code nonzero and suppresses that line.

    python chip_smoke.py               # one card, the phases above
    python chip_smoke.py --devices 4   # only the sharded 502,599-dof phase
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# max |Δlbd| between two runs of the same load steps (bench.py's
# sharded-vs-local bound: ~1e-4 relative on a lbd ~ 1 history, far below a
# changed equilibrium path).  On the graded plate the f32 residual floor
# (~1.5e-4 relative) makes f32-vs-f64 land at 3.5e-5..9.6e-5 on the H100,
# so the bound is tight there (PERF.md).
LBD_TOL = 1.0e-4
# f64 closed form: the recursion is exact, the solve is converged to 1e-11
CLOSED_FORM_RTOL = 1.0e-9
# coarse tet10 column: a few % stiff (tests/test_buckling_gnl.py)
EULER_RTOL = 0.03
# device-memory bandwidth by device_kind (NVIDIA H100 SXM data sheet)
PEAK_HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
OUT_DIR = os.path.join(ROOT, ".smoke_out")

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


def card_info() -> str:
    """``name, power.limit`` of the first card, read by nvidia-smi (no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {type(err).__name__}"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: no card"


def require_gpu(devices, count: int = 1):
    """Refuse to go on without ``count`` GPU devices (never fall back)."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        print(f"chip_smoke: no GPU (JAX backend is {platform})",
              file=sys.stderr)
        raise SystemExit(2)
    if len(devices) < count:
        print(f"chip_smoke: {count} GPUs requested, {len(devices)} found",
              file=sys.stderr)
        raise SystemExit(2)
    return devices


def last_line(devices) -> dict:
    """The final result line: ``ok`` and the device as JAX reports it."""
    return {
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (monitoring hook)."""

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, event, duration, **_):
        if event in _COMPILE_EVENTS:
            self.seconds += duration


@contextlib.contextmanager
def precision_tier(dtype: str):
    """Run the solver in ``dtype`` ("float32"/"float64"), restoring after."""
    import jax

    from fcvm_tpu.config import get_config

    cfg = get_config()
    prev = (cfg.dtype, jax.config.read("jax_enable_x64"))
    cfg.dtype = dtype
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        yield
    finally:
        cfg.dtype = prev[0]
        jax.config.update("jax_enable_x64", prev[1])


@contextlib.contextmanager
def config_override(**kw):
    from fcvm_tpu.config import get_config

    cfg = get_config()
    prev = {k: getattr(cfg, k) for k in kw}
    for k, v in kw.items():
        setattr(cfg, k, v)
    try:
        yield
    finally:
        for k, v in prev.items():
            setattr(cfg, k, v)


def compare_lbd(res, ref) -> dict:
    """Same step count and max |Δlbd| <= LBD_TOL over the load history."""
    a = np.asarray(res.history.lbd, dtype=np.float64)
    b = np.asarray(ref.history.lbd, dtype=np.float64)
    same = len(a) == len(b)
    diff = float(np.max(np.abs(a - b))) if same else math.inf
    rel = float(np.max(np.abs(a - b)[1:] / np.abs(b[1:]))) if same else math.inf
    return {
        "steps": len(a) - 1, "steps_ref": len(b) - 1,
        "lbd": a.tolist(), "lbd_ref": b.tolist(),
        "max_dlbd": diff, "max_rel_dlbd": rel, "dlbd_tol": LBD_TOL,
        "ok": same and diff <= LBD_TOL,
    }


def plate_params():
    """Three plastic Riks steps with GNL on the plate with a hole: yield at
    the hole from the first step (LF ~0.27), 10% hardening so the path has
    no limit point and two equally converged runs stay on one path.
    ``error_max`` is the reference's default, 1e-3: well above the f32
    residual floor of this graded mesh (~1.5e-4 at 28.6k dof on CPU), so
    the f32 tier converges without its precision ladder and takes the same
    Newton iterations as the f64 reference."""
    import fcvm_tpu

    return fcvm_tpu.ControlParams(
        sig_yield=40.0, nstep=3, error_max=1e-3, et_e=0.1, target_lf=99.0,
        gnl="GNLY", max_imp=0.0,
    )


def step_stats(res) -> dict:
    """Per-run counters the full-size phase reports."""
    nsteps = max(len(res.history.lbd) - 1, 1)
    keys = ("solves", "iters", "newton_iterations", "dispatches",
            "fused_iterations", "hp_matvec_activations",
            "refinement_activations", "floor_clamps", "f64_reruns")
    return {
        "steps": nsteps,
        "stepping_s": res.timers.get("stepping", 0.0),
        "wall_per_step_s": res.timers.get("stepping", 0.0) / nsteps,
        **{f"cg_{k}": res.cg_stats.get(k) for k in keys},
    }


def lbd_parity(model, params, ref_device) -> dict:
    """f32 CG tier on the default device vs the f64 scipy direct tier on
    ``ref_device`` (the plain reference shares no device with the code
    under test), compared by :func:`compare_lbd`."""
    import jax

    import fcvm_tpu

    with precision_tier("float32"):
        res = fcvm_tpu.solve_collapse(model, params)
    with precision_tier("float64"), config_override(solver="scipy"), \
            jax.default_device(ref_device):
        ref = fcvm_tpu.solve_collapse(model, params)
    out = compare_lbd(res, ref)
    out["precision"] = "f32 cg (default device) vs f64 scipy direct (cpu)"
    out["cg_iters"] = res.cg_stats["iters"]
    out["newton_iterations"] = res.cg_stats.get("newton_iterations")
    out["newton_iterations_ref"] = ref.cg_stats.get("newton_iterations")
    return out


# -- phases -------------------------------------------------------------------


def _repo_module(relpath: str):
    """Import a file of this checkout by path (another installed package
    may own the name ``tests``)."""
    import importlib.util

    name = "_chip_smoke_" + os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_closed_form():
    import fcvm_tpu

    ref = _repo_module(os.path.join("tests", "test_driver_collapse.py"))
    mesh, model = ref.uniaxial_model()
    params = fcvm_tpu.ControlParams(
        sig_yield=ref.SY0, nstep=22, iterat_max=20, error_max=1e-11,
        et_e=0.1, target_lf=99.0, ultimate_strain=0.25,
    )
    with precision_tier("float64"):
        res = fcvm_tpu.solve_collapse(model, params)
    eps, peeq, _ = ref.reference_1d_recursion(res.history.lbd[1:], 0.1)
    end = mesh.select_nodes(lambda x, y, z: x > ref.L - 1e-9)
    ux = float(res.disp_total.reshape(-1, 3)[end, 0].mean())
    rel_ux = abs(ux - eps * ref.L) / (eps * ref.L)
    rel_peeq = abs(float(res.peeq_gp.max()) - peeq) / peeq
    return {
        "precision": "f64", "lbd_final": float(res.history.lbd[-1]),
        "rel_err_ux": rel_ux, "rel_err_peeq": rel_peeq,
        "rtol": CLOSED_FORM_RTOL,
        "ok": (res.history.lbd[-1] > 2.4 and rel_ux <= CLOSED_FORM_RTOL
               and rel_peeq <= CLOSED_FORM_RTOL),
    }


def phase_matched_size():
    import jax

    from bench import PLATE_SMALL, build_plate

    mesh, model = build_plate(PLATE_SMALL)
    out = lbd_parity(model, plate_params(), jax.devices("cpu")[0])
    out["ndof"] = mesh.ndof
    return out


def time_cg_iteration(model, n_iters=(50, 150)) -> dict:
    """One CG iteration and one operator matvec of the production solve at
    this mesh, on the card, f32.  The matvec is XLA's gather -> (ne, 30, 30)
    block einsum -> ScatterPlan reduce in the Morton solve space; its
    element-block stream is ``ne * 30 * 30 * 4`` bytes."""
    import jax
    import jax.numpy as jnp

    from fcvm_tpu.config import get_config
    from fcvm_tpu.ops import assembly as asm
    from fcvm_tpu.runtime import system as sysm
    from fcvm_tpu.runtime.backend import LocalSystem

    dtype = jnp.float32
    bk = LocalSystem(model, get_config(), dtype)
    coords = jnp.asarray(model.mesh.coords, dtype)
    esm, pinv, _, rhs, *_ = bk.assemble(model.mesh.coords)
    pc = jax.block_until_ready(bk.make_pc(esm, pinv, coords))
    space = bk.space
    esm_m = esm[space.eperm]
    eldofs = asm.element_dof_ids(space.elnodes_m)
    ne = int(esm.shape[0])

    # operands go in as arguments: a jit closing over the 0.4 GB of blocks
    # would embed them in the program as constants
    @functools.partial(jax.jit, static_argnames=("n", "precision"))
    def chain(esm_m, eldofs, fixmask_m, plan_m, x, n, precision):
        kv = asm.make_bc_matvec(esm_m, eldofs, fixmask_m, plan_m,
                                precision=precision)

        def body(_, v):
            y = kv(v)
            return y * jax.lax.rsqrt(jnp.vdot(y, y))

        return jax.lax.fori_loop(0, n, body, x)

    def timed(fn, *args):
        jax.block_until_ready(fn(*args))  # compile + warm
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        return time.perf_counter() - t0

    x0 = space.to_m(rhs)
    x0 = x0 / jnp.linalg.norm(x0)
    n_lo, n_hi = n_iters
    out = {"ne": ne, "ndof_pad": int(space.fixmask_m.shape[0])}
    resolved = asm.resolve_matvec_precision(int(space.fixmask_m.shape[0]))
    out["matvec_precision_resolved"] = "highest" if resolved else "default"
    ops = (esm_m, eldofs, space.fixmask_m, space.plan_m, x0)
    for name, prec in (("default", None),
                       ("highest", jax.lax.Precision.HIGHEST)):
        t_lo = timed(functools.partial(chain, n=n_lo, precision=prec), *ops)
        t_hi = timed(functools.partial(chain, n=n_hi, precision=prec), *ops)
        out[f"matvec_ms_{name}"] = (t_hi - t_lo) / (n_hi - n_lo) * 1e3
    # default vs HIGHEST on one vector: a TF32 dot would show ~1e-3 here
    y_d = chain(*ops, n=1, precision=None)
    y_h = chain(*ops, n=1, precision=jax.lax.Precision.HIGHEST)
    out["matvec_default_vs_highest_relerr"] = float(
        jnp.linalg.norm(y_d - y_h) / jnp.linalg.norm(y_h))

    def solve(n):
        return sysm.solve_displacement(
            esm, bk.elnodes, bk.fixmask, pc, rhs, 0.0, n, plan=bk.plan,
            space=space,
        )

    res_lo = jax.block_until_ready(solve(n_lo))
    res_hi = jax.block_until_ready(solve(n_hi))
    t_lo = timed(solve, n_lo)
    t_hi = timed(solve, n_hi)
    di = int(res_hi.iters) - int(res_lo.iters)
    out["cg_iters_timed"] = [int(res_lo.iters), int(res_hi.iters)]
    out["cg_iter_ms"] = (t_hi - t_lo) / max(di, 1) * 1e3
    block_bytes = ne * 30 * 30 * 4
    out["element_block_bytes"] = block_bytes
    coarse = getattr(pc, "coarse_inv", None)
    if coarse is not None:
        out["coarse_inverse_bytes"] = int(coarse.size * coarse.dtype.itemsize)
    # what a plain streaming kernel reaches on this card: read + write of
    # an array the size of the element blocks, chained so nothing is elided
    @functools.partial(jax.jit, static_argnames=("n",))
    def stream(x, n):
        return jax.lax.fori_loop(0, n, lambda _, v: v * 0.5 + 1.0, x)

    x = jnp.zeros((ne * 900,), dtype)
    t_lo = timed(functools.partial(stream, n=n_lo), x)
    t_hi = timed(functools.partial(stream, n=n_hi), x)
    out["stream_bytes_per_s"] = 2 * block_bytes * (n_hi - n_lo) / (t_hi - t_lo)
    out["matvec_block_bytes_per_s"] = (
        block_bytes / (out["matvec_ms_default"] * 1e-3))
    kind = jax.devices()[0].device_kind
    peak = PEAK_HBM_BYTES_PER_S.get(kind)
    if peak is None:
        out["hbm_share"] = f"device kind {kind!r} not in the peak table"
    else:
        out["peak_hbm_bytes_per_s"] = peak
        out["matvec_block_hbm_share"] = out["matvec_block_bytes_per_s"] / peak
        out["stream_hbm_share"] = out["stream_bytes_per_s"] / peak
    return out


def phase_full_size():
    import jax

    import fcvm_tpu
    from bench import PLATE_BIG, build_plate

    mesh, model = build_plate(PLATE_BIG)
    params = plate_params()
    out = {"ndof": mesh.ndof, "n_elements": mesh.n_elements}
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    try:
        with precision_tier("float32"):
            t0 = time.perf_counter()
            res = fcvm_tpu.run_analysis(model, params, outdir=OUT_DIR,
                                        save_plots=False)
            out["f32_cold_wall_s"] = time.perf_counter() - t0
            written = sorted(os.listdir(OUT_DIR))
            t0 = time.perf_counter()
            warm = fcvm_tpu.solve_collapse(model, params)
            out["f32_warm_wall_s"] = time.perf_counter() - t0
            out["f32"] = step_stats(res)
            out["f32_warm"] = step_stats(warm)
            out["kernel"] = time_cg_iteration(model)
    finally:
        shutil.rmtree(OUT_DIR, ignore_errors=True)
    out["files_written"] = written
    with precision_tier("float64"):
        t0 = time.perf_counter()
        res64 = fcvm_tpu.solve_collapse(model, params)
        out["f64_wall_s"] = time.perf_counter() - t0
    out["f64"] = step_stats(res64)
    cmp = compare_lbd(res, res64)
    out["f32_vs_f64"] = cmp
    # run-to-run spread of the f32 tier on the card (reported, not judged)
    out["f32_warm_vs_cold_max_dlbd"] = compare_lbd(warm, res)["max_dlbd"]
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    out["ok"] = (
        cmp["ok"]
        and res.cg_stats.get("f64_reruns") == 0
        and res.history.lbd[-1] > 0.0
        and {f"{model.name}.out", f"{model.name}.vtk"} <= set(written)
        and bool(np.all(np.isfinite(res.disp_total)))
    )
    return out


def phase_buckling():
    import fcvm_tpu
    from fcvm_tpu.models.casefile import load_case

    model, params = load_case(os.path.join(ROOT, "examples", "euler_column.toml"))
    e, lc, w, p = 210000.0, 20.0, 1.0, 1000.0  # the case file's column
    p_cr = math.pi**2 * e * (w**4 / 12) / (4 * lc**2)  # clamped-free Euler
    # f64, as the tests check it: the f32 tier's inner solves stall on this
    # slender pencil and its f64-iteration retry keeps the f32 pre-stress
    with precision_tier("float64"):
        lam, _ = fcvm_tpu.linear_buckling(model, params, k=2)
    lam = np.asarray(lam, dtype=np.float64)
    rel = np.abs(lam / (p_cr / p) - 1.0)
    return {
        "precision": "f64", "factors": lam.tolist(), "euler": p_cr / p,
        "rel_err": rel.tolist(), "rtol": EULER_RTOL,
        "ok": bool(np.all(rel <= EULER_RTOL)),
    }


def _progress(msg: str) -> None:
    """Driver progress on stderr with a timestamp, so that a run cut by a
    time limit still shows how far it got."""
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def phase_sharded(n_devices: int):
    """The 502,599-dof plate sharded over ``n_devices`` under both
    collective layouts vs a single-device run of the same steps."""
    import fcvm_tpu
    from bench import PLATE_BIG, build_plate

    mesh, model = build_plate(PLATE_BIG)
    params = plate_params()
    out = {"ndof": mesh.ndof, "n_devices": n_devices, "precision": "f32"}
    with precision_tier("float32"):
        t0 = time.perf_counter()
        _progress("single-device reference")
        ref = fcvm_tpu.solve_collapse(model, params, progress=_progress)
        out["single_wall_s"] = time.perf_counter() - t0
        out["single"] = step_stats(ref)
        ok = True
        for node_partition in (False, True):
            with config_override(n_devices=n_devices,
                                 node_partition=node_partition):
                t0 = time.perf_counter()
                _progress(f"sharded, node_partition={node_partition}")
                res = fcvm_tpu.solve_collapse(model, params,
                                              progress=_progress)
                wall = time.perf_counter() - t0
            row = compare_lbd(res, ref)
            row.update(step_stats(res), wall_s=wall)
            out["node_partition" if node_partition else "replicated"] = row
            ok = ok and row["ok"]
    out["ok"] = ok
    return out


def run_phase(name, fn, card, clock) -> bool:
    """Run one phase; print its JSON line; a raised error fails the phase."""
    c0, t0 = clock.seconds, time.perf_counter()
    try:
        out = fn()
    except Exception as err:  # reported, and the exit code says so
        traceback.print_exc()
        out = {"ok": False, "error": f"{type(err).__name__}: {err}"}
    out = {"phase": name, "ok": bool(out.pop("ok")), **out,
           "wall_s": time.perf_counter() - t0,
           "compile_s": clock.seconds - c0, "card": card}
    print(json.dumps(out, default=str), flush=True)
    return out["ok"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the sharded phase on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = require_gpu(jax.devices(), args.devices)
    card = card_info()
    from fcvm_tpu.config import enable_compilation_cache

    cache = enable_compilation_cache()
    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    print(json.dumps({
        "phase": "device", "ok": True, "platform": devices[0].platform,
        "kind": devices[0].device_kind, "count": len(devices),
        "card": card, "compile_cache": cache,
    }), flush=True)

    if args.devices > 1:
        phases = [("sharded", lambda: phase_sharded(args.devices))]
    else:
        phases = [
            ("closed_form", phase_closed_form),
            ("matched_size", phase_matched_size),
            ("full_size", phase_full_size),
            ("buckling", phase_buckling),
        ]
    ok = True
    for name, fn in phases:
        ok = run_phase(name, fn, card, clock) and ok
    print(card, flush=True)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps(last_line(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
