"""Strip-footing DP solves at scale: the df32+cg footing path.

The reference's footing benchmark runs only at level 1 (dense masked
solve, `Plasticity2D_DP/pythonFEM.py:901-1157`); its O(n^2) dense
pipeline cannot represent refined levels at all.  This runs the COMPLETE
adaptive pressure-controlled schedule (semi-smooth Newton, dzeta
doubling rule, near-incompressible nu=0.48) at refined levels with
matrix-free f32 block-Jacobi PCG tangent solves and the double-float
residual/criterion (`models/footing.py` solver="cg", precision="df32").

Run:  python -m fem_elastoplasticity_tpu.benchmarks.footing_scale_bench [levels...]

Level sizes (P1): level 1 = 800 elems / 441 nodes, 2 = 3.2k/1.7k,
3 = 12.8k/6.6k, 4 = 51.2k/26k, 5 = 204.8k/103k.

Recorded schedules (counts, not times): the cg and assembled full-tangent
paths reach the same limit pressures (level 1: 17 steps, 16.8362; level
2: 17.681, cg-vs-assembled 2e-6 rel); the step-count spread at level >= 2
is the adaptive controller reacting to inexact f32 tangent solves near
the limit load.  Block-Jacobi CG iteration counts (~h^-1 growth, nu =
0.48) are the scale bottleneck.

Level >= 4 runs the `FootingConfig.fast_scale` preset (tangent
multigrid + cg_cap_relax + achievable tolerances — config.py doc):
  python -m fem_elastoplasticity_tpu.benchmarks.footing_scale_bench 4 --scale
Level 4 (51.8k DOFs) completes the full pressure schedule in 290 steps /
2270 Newton its / 3.84M CG its, limit pressure 20.4259.
"""
from __future__ import annotations

import json
import sys
import time


def run_footing_scale(
    levels=(1, 2, 3), reps: int = 3, verbose: bool = True,
    scale_preset: bool = False, **cfg_kw
):
    """cfg_kw: extra FootingConfig.fast overrides (A/B runs, e.g.
    assembled_cg=True for the full-tangent slot-refresh path).
    scale_preset: use FootingConfig.fast_scale (tangent-MG production
    config for level >= 4 — module docstring)."""
    import numpy as np

    from ..models.config import FootingConfig
    import jax

    from ..models.footing import build_df32, _package_df32

    results = []
    for level in levels:
        if scale_preset:
            cfg = FootingConfig.fast_scale(level, **cfg_kw)
        else:
            kw = dict(solver="cg", cg_maxiter=4000)
            kw.update(cfg_kw)
            cfg = FootingConfig.fast(level=level, **kw)
        t0 = time.perf_counter()
        run, args, mesh = build_df32(cfg)
        runner = lambda: jax.block_until_ready(run(args))
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = _package_df32(runner(), mesh)
        first = time.perf_counter() - t0
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = _package_df32(runner(), mesh)
            walls.append(time.perf_counter() - t0)
        rec = {
            "level": level,
            "n_elems": int(r.mesh.n_elems),
            "n_dofs": int(2 * r.mesh.n_nodes),
            "wall_s": float(np.median(walls)) if walls else first,
            "first_incl_compile_s": first,
            "setup_s": setup,
            "n_steps": int(r.n_steps),
            "n_newton_total": int(r.n_newton_total),
            "n_cg_total": int(r.n_cg_total),
            "n_plastic": int(r.n_plastic),
            "cg_deflate": int(getattr(cfg, "cg_deflate", 0)),
            "limit_pressure": float(r.pressure_hist[r.n_steps]),
            "zeta_end": float(np.asarray(r.zeta_hist).max()),
        }
        results.append(rec)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    scale = "--scale" in sys.argv
    kw = {}
    for a in sys.argv[1:]:
        if a.startswith("--deflate="):
            kw["cg_deflate"] = int(a.split("=", 1)[1])
        elif a.startswith("--reps="):
            kw["reps"] = int(a.split("=", 1)[1])
    lv = tuple(
        int(x) for x in sys.argv[1:] if not x.startswith("-")
    ) or (1, 2, 3)
    run_footing_scale(levels=lv, scale_preset=scale, **kw)
