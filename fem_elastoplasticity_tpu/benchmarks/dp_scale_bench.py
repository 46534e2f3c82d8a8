"""Large-mesh full Drucker-Prager solves: the df32 fast path at scale.

Runs the COMPLETE adaptive load-stepped excavation (17-step schedule,
semi-smooth Newton, return map, criterion — everything bench.py runs on
the parity mesh) on uniformly refined tsx meshes, with matrix-free f32
tangent solves preconditioned by a geometric-multigrid V-cycle and the
Newton residual/criterion in double-float (solve/newton.py
precision="df32").

This is the scaling axis the reference's dense boolean-masked pipeline
cannot enter at all (`Elasticity2D/pythonFEM.py:1151-1159` builds the
O(n^2) dense stiffness; >10 min at level 3 for one ELASTIC solve).

Run:  python -m fem_elastoplasticity_tpu.benchmarks.dp_scale_bench [levels...]

Prints one JSON record per level: set-up, compile-plus-first and warm
walls (synced with `jax.block_until_ready`), the solver counts and the
monitored wall displacement u40, which converges toward the P4 value
-2.267e-3 under refinement as the plastic zone is better resolved.
"""
from __future__ import annotations

import json
import sys
import time


def run_dp_scale(
    levels=(1, 2, 3), reps: int = 3, verbose: bool = True, **cfg_kw
):
    """cfg_kw: extra TsxTunnelConfig.fast_scale overrides (A/B runs,
    e.g. corr_mode="scatter")."""
    import jax
    import numpy as np

    from ..models import tsx_tunnel as tsx
    from ..models.config import TsxTunnelConfig

    results = []
    for level in levels:
        cfg = (
            # the documented large-mesh preset at every level (inexact
            # Newton cg_tol 1e-5 + Eisenstat-Walker forcing; trajectory
            # measured identical to the 2e-7-floor runs at levels 1-2)
            TsxTunnelConfig.fast_scale(level, **cfg_kw)
        )
        t0 = time.perf_counter()
        run, args, mesh = tsx.build_df32(cfg)
        t_setup = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = jax.block_until_ready(run(args))
        t_first = time.perf_counter() - t0  # compile + first execution

        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = jax.block_until_ready(run(args))
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))

        # monitored tunnel-wall u_x at the last accepted step — the
        # stepper's monitor uses the (possibly ELL-permuted) node id
        k = int(res.n_steps) - 1
        u40 = float(np.asarray(res.monitor_hist.hi, np.float64)[k]) + float(
            np.asarray(res.monitor_hist.lo, np.float64)[k]
        )
        rec = {
            "level": level,
            "n_elems": int(mesh.n_elems),
            "n_dofs": int(2 * mesh.n_nodes),
            "wall_s": wall,
            "setup_s": t_setup,
            "compile_plus_first_s": t_first,
            "n_steps": int(res.n_steps),
            "n_newton_total": int(res.n_newton_total),
            "n_cg_total": int(getattr(res, "n_cg_total", -1)),
            "n_plastic": int(res.n_plastic),
            "u40": u40,
        }
        results.append(rec)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    lv = tuple(int(x) for x in sys.argv[1:]) or (1, 2, 3)
    run_dp_scale(levels=lv)
