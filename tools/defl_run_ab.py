"""Deflation pay-or-park: retained-space amortization over a long run.

Per-step Ritz-deflation re-harvesting was measured perf-neutral at bench
scale (the undeflated harvest solve eats the
in-step savings); the retained-space policy's win case is a MANY-step run
where one harvest amortizes.  This probe runs the production driver for
>= 10 plastic GNL Riks steps on the 499k-dof box with the recycling on
vs off and reports stepping wall + cg totals — the number that decides
whether `config.deflation` stays default-on for the driver hot path.

Usage: python tools/defl_run_ab.py [nsteps] [on|off|both]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fcvm_tpu.config import enable_compilation_cache, get_config

enable_compilation_cache()

import bench  # noqa: E402
import fcvm_tpu  # noqa: E402

NX = int(os.environ.get("FCVM_PROBE_NX", "27"))


def run_one(nsteps, deflation):
    cfg = get_config()
    _, model = bench.build(NX)
    # hardening keeps every step convergent; sig_yield 25 puts the whole
    # run in the plastic regime from step 1 (bench sharded-row physics)
    params = fcvm_tpu.ControlParams(
        sig_yield=25.0, nstep=nsteps, error_max=1e-5, et_e=0.1,
        target_lf=99.0, gnl="GNLY", max_imp=0.0,
    )
    old = (cfg.deflation, cfg.load_deflation)
    cfg.deflation = deflation
    cfg.load_deflation = deflation
    lines = []
    t0 = time.perf_counter()
    try:
        res = fcvm_tpu.solve_collapse(model, params, progress=lines.append)
    finally:
        cfg.deflation, cfg.load_deflation = old
    wall = time.perf_counter() - t0
    nst = max(len(res.history.lbd) - 1, 1)
    st = res.timers.get("stepping", 0.0)
    cs = res.cg_stats
    restarts = sum("RESTART #" in ln for ln in lines)
    print(
        f"[deflation={'on' if deflation else 'off'}] wall {wall:.1f}s "
        f"stepping {st:.1f}s ({st / nst * 1e3:.0f} ms/step, {nst} steps) "
        f"cg {cs['iters']} iters / {cs['solves']} solves "
        f"(+pred {cs['predictor_iters']}/{cs['predictor_solves']}), "
        f"newton {cs.get('newton_iterations')}, restarts {restarts}, "
        f"hp {cs.get('hp_matvec_activations')}",
        flush=True,
    )
    print(f"  lbd tail: {[round(float(v), 5) for v in res.history.lbd[-4:]]}",
          flush=True)
    return st / nst


def main():
    nsteps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    mode = sys.argv[2] if len(sys.argv) > 2 else "both"
    out = {}
    if mode in ("on", "both"):
        out["on"] = run_one(nsteps, True)
    if mode in ("off", "both"):
        out["off"] = run_one(nsteps, False)
    if len(out) == 2:
        print(f"off/on per-step ratio: {out['off'] / out['on']:.3f}",
              flush=True)


if __name__ == "__main__":
    main()
