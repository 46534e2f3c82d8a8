"""Elastic excavation solves at scale on the windowed-ELL fast path.

Same problem as `elastic_df32_sweep` (complete f64-grade elastic solve
K u = -F0 per refinement level: f32 MG-PCG + df32 iterative refinement)
but every V-cycle / CG operator application is an assembled operator
(`ops/spmv.py`) instead of the matrix-free path.

Run:  python -m fem_elastoplasticity_tpu.benchmarks.elastic_ell_sweep [levels...]
"""
from __future__ import annotations

import json
import sys
import time


def run_elastic_ell_sweep(levels=(0, 1, 2, 3, 4, 5), reps: int = 3,
                          verbose=True, fmt: str = "slot"):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..mesh.refine import refine_uniform
    from ..models.config import TsxTunnelConfig
    from ..models.tsx_tunnel import _DATA, initial_state
    from ..ops import assembly_df as adf
    from ..ops import spmv
    from ..ops.df32 import DF
    from ..models.materials import lame_moduli
    from ..ops.elements import ElementType, volume_element
    from ..solve import multigrid as mgm
    from ..solve.cg import solve_cg

    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    s0, _ = initial_state(cfg)
    ref = volume_element(ElementType.P1)
    f32 = jnp.float32

    def _free_fn(cc):
        fr = np.ones((cc.shape[0], 2), dtype=bool)
        fr[np.abs(cc[:, 0]) > 49.99, 0] = False
        fr[np.abs(cc[:, 1]) > 49.99, 1] = False
        return fr

    raw = np.load(_DATA)
    results = []
    for level in levels:
        t0 = time.perf_counter()
        mg_arrays, mg_metas, perms, coarse = mgm.build_hierarchy_ell(
            raw["coords"].astype(np.float64), raw["elems"], level,
            _free_fn, shear, bulk, ref, fmt=fmt,
        )
        # permuted finest mesh for the df32 residual geometry
        coords, elems = raw["coords"].astype(np.float64), raw["elems"]
        for _ in range(level):
            coords, elems = refine_uniform(coords, elems)
        order = np.argsort(perms[-1], kind="stable")
        coords2, elems2, _ = spmv.permute_mesh(coords, elems, order)
        free2 = _free_fn(coords2)
        gdf = adf.geometry_df(coords2, elems2, ref)
        s0_hi, s0_lo = adf.split_f64_np(s0)
        n_nodes, n_q, n_real = coords2.shape[0], gdf.hi.n_q, gdf.hi.n_real
        meta_top = mg_metas[-1]["op"]

        args = dict(
            B_hi=gdf.hi.B, w_hi=gdf.hi.weight,
            edofs=gdf.hi.edofs, edofs_t=gdf.hi.edofs_t,
            B_lo=gdf.B_lo, w_lo=gdf.w_lo, gmap=gdf.gmap,
            free_mask=jnp.asarray(free2),
            s0_hi=jnp.asarray(s0_hi), s0_lo=jnp.asarray(s0_lo),
            mg=mg_arrays, inv0=coarse["inv0"],
            free_idx0=coarse["free_idx0"],
        )
        t_setup = time.perf_counter() - t0

        from ..ops import assembly as asm

        def geom_of(a):
            return adf.GeometryDF(
                hi=asm.Geometry(
                    B=a["B_hi"], weight=a["w_hi"], edofs=a["edofs"],
                    edofs_t=a["edofs_t"], n_nodes=n_nodes, n_q=n_q,
                    n_real=n_real,
                ),
                B_lo=a["B_lo"], w_lo=a["w_lo"], gmap=a["gmap"],
            )

        @jax.jit
        def ir_pass(a, u_hi, u_lo):
            g = geom_of(a)
            n_int = g.hi.n_int
            bc = lambda x: jnp.broadcast_to(x[:3, None], (3, n_int))
            f0 = adf.internal_force_df(g, DF(bc(a["s0_hi"]), bc(a["s0_lo"])))

            idx0 = a["free_idx0"]

            def coarse_solve(r):
                return jnp.zeros_like(r).at[idx0].set(a["inv0"] @ r[idx0])

            pre = mgm.make_vcycle_ell(mg_metas, coarse_solve, nu=2)
            u = DF(u_hi, u_lo)
            r = adf.df_add(
                DF(-f0.hi, -f0.lo),
                DF(*map(jnp.negative, adf.elastic_apply_df(g, u, shear, bulk))),
            )
            res = solve_cg(
                lambda v: spmv.sp_matvec(a["mg"][-1]["op"], meta_top, v),
                r.hi, a["free_mask"], precond=lambda rr: pre(a["mg"], rr),
                tol=2e-7, maxiter=16, structure="scan",
            )
            u = adf.df_add(u, DF(res.x, jnp.zeros_like(res.x)))
            return u.hi, u.lo, res.iters

        def run(a):
            u_hi = jnp.zeros((2 * n_nodes,), f32)
            u_lo = jnp.zeros_like(u_hi)
            iters = []
            for _ in range(3):
                u_hi, u_lo, k = ir_pass(a, u_hi, u_lo)
                iters.append(k)
            jax.block_until_ready(u_hi)
            return DF(u_hi, u_lo), np.asarray(iters)

        t0 = time.perf_counter()
        u, cg_iters = run(args)
        t_first = time.perf_counter() - t0
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(args)
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))

        rec = {
            "level": level,
            "n_elems": int(elems2.shape[0]),
            "n_dofs": int(2 * n_nodes),
            "wall_s": wall,
            "setup_s": t_setup,
            "compile_plus_first_s": t_first,
            "J_op": getattr(meta_top, "J", None) or getattr(
                meta_top, "s_pad", None
            ),
            "cg_iters_per_ir_pass": [int(x) for x in np.asarray(cg_iters)],
            "u_max": float(
                np.abs(
                    np.asarray(u.hi, np.float64) + np.asarray(u.lo, np.float64)
                ).max()
            ),
        }
        results.append(rec)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    lv = tuple(int(x) for x in sys.argv[1:]) or (0, 1, 2, 3, 4, 5)
    run_elastic_ell_sweep(levels=lv)
