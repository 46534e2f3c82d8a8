"""64-way material-ensemble benchmark (BASELINE config).

Batches the full tsx excavation over an 8x8 (cohesion, friction-angle)
grid with `vmap` (shared geometry, batched return mapping / assembly /
Cholesky), and reports aggregate throughput: solves per second versus the
reference's 1.36 s-per-solve serial CPU baseline.
"""
from __future__ import annotations

import json
import time

import jax
import numpy as np

REFERENCE_SOLVE_S = 1.36  # BASELINE.md measured, per solve


def run_ensemble_bench(n_cohesion=8, n_friction=8, verbose=True) -> dict:
    from ..models.config import TsxTunnelConfig
    from ..parallel.ensemble import material_grid, solve_tsx_ensemble

    cohesions = np.linspace(14.0, 25.0, n_cohesion)
    frictions = np.deg2rad(np.linspace(40.0, 55.0, n_friction))
    eta, c = material_grid(cohesions, frictions)
    n_b = len(eta)


    def sync(res):
        return jax.block_until_ready(res)

    # pure-f32 preset: the ensemble stepper is the native f32 path
    cfg = TsxTunnelConfig.fast_f32()
    t0 = time.perf_counter()
    res = sync(solve_tsx_ensemble(eta, c, cfg))
    first = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = sync(solve_tsx_ensemble(eta, c, cfg))
    warm = time.perf_counter() - t0

    # df32 preset: every member an f64-grade (1e-12/1e-10 criteria) solve
    from ..parallel.ensemble import solve_tsx_ensemble_df32

    t0 = time.perf_counter()
    res_df = sync(solve_tsx_ensemble_df32(eta, c))
    first_df = time.perf_counter() - t0

    t0 = time.perf_counter()
    res_df = sync(solve_tsx_ensemble_df32(eta, c))
    warm_df = time.perf_counter() - t0

    rec = {
        "ensemble_size": int(n_b),
        "first_wall_s": first,
        "warm_wall_s": warm,
        "solves_per_s": n_b / warm,
        "vs_serial_reference": n_b * REFERENCE_SOLVE_S / warm,
        "min_steps": int(np.asarray(res.n_steps).min()),
        "max_steps": int(np.asarray(res.n_steps).max()),
        "df32_first_wall_s": first_df,
        "df32_warm_wall_s": warm_df,
        "df32_solves_per_s": n_b / warm_df,
        "df32_vs_serial_reference": n_b * REFERENCE_SOLVE_S / warm_df,
        "df32_min_steps": int(np.asarray(res_df.n_steps).min()),
        "df32_max_steps": int(np.asarray(res_df.n_steps).max()),
    }
    if verbose:
        print(json.dumps(rec), flush=True)
    return rec


def run_ensemble_scale_bench(
    n_members=16, refine_levels=1, zeta_max=1.0, verbose=True
) -> dict:
    """Refined-mesh df32 ensemble: full adaptive solves
    batched over materials at refine_levels >= 1 via matrix-free PCG
    members (solver='cg' — parallel/ensemble.py docstring)."""
    from ..models.config import TsxTunnelConfig
    from ..parallel.ensemble import material_grid, solve_tsx_ensemble_df32

    nc = max(2, int(np.sqrt(n_members)))
    nf = -(-n_members // nc)
    cohesions = np.linspace(14.0, 25.0, nc)
    frictions = np.deg2rad(np.linspace(42.0, 55.0, nf))
    eta, c = material_grid(cohesions, frictions)
    eta, c = eta[:n_members], c[:n_members]
    cfg = TsxTunnelConfig.fast(
        solver="cg", refine_levels=refine_levels, zeta_max=zeta_max
    )

    def sync(res):
        return jax.block_until_ready(res)

    t0 = time.perf_counter()
    res = sync(solve_tsx_ensemble_df32(eta, c, cfg=cfg))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sync(solve_tsx_ensemble_df32(eta, c, cfg=cfg))
    warm = time.perf_counter() - t0
    rec = {
        "ensemble_size": int(len(eta)),
        "refine_levels": int(refine_levels),
        "zeta_max": float(zeta_max),
        "first_wall_s": first,
        "warm_wall_s": warm,
        "solves_per_s": len(eta) / warm,
        "min_steps": int(np.asarray(res.n_steps).min()),
        "max_steps": int(np.asarray(res.n_steps).max()),
    }
    if verbose:
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    import sys

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if "--scale" in sys.argv:
        kw = {}
        for a in sys.argv[1:]:
            if a.startswith("--members="):
                kw["n_members"] = int(a.split("=", 1)[1])
            elif a.startswith("--refine="):
                kw["refine_levels"] = int(a.split("=", 1)[1])
        run_ensemble_scale_bench(**kw)
    else:
        run_ensemble_bench()
