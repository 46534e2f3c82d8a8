"""Elastic excavation solves at scale on the df32 fast path.

Per refinement level of the tsx mesh, one COMPLETE f64-grade elastic
solve K u = -F0: f32 matrix-free CG preconditioned by the geometric
multigrid V-cycle, iteratively refined with the double-float residual
(`ops.assembly_df.refine_elastic_solve_with`) to the ~1e-14 df32 floor.
This is the scalable answer to the reference's dense elastic pipeline
(`Elasticity2D/pythonFEM.py:1151-1159`, >10 min at level 3).

Accuracy gate: at the levels where the f64 CPU solve is cheap enough,
the df32 solution is compared against it.

Run:  python -m fem_elastoplasticity_tpu.benchmarks.elastic_df32_sweep [levels...]
"""
from __future__ import annotations

import json
import sys
import time


def run_elastic_df32_sweep(levels=(0, 1, 2, 3, 4), reps: int = 3, verbose=True):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..models.config import TsxTunnelConfig
    from ..models.materials import elastic_tangent_lanes, lame_moduli
    from ..models.tsx_tunnel import _DATA, initial_state, tsx_mesh
    from ..ops import assembly as asm
    from ..ops import assembly_df as adf
    from ..ops.df32 import DF
    from ..ops.elements import ElementType, tables, volume_element
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

    results = []
    for level in levels:
        t0 = time.perf_counter()
        mesh = tsx_mesh(ElementType.P1, refine_levels=level)
        gdf = adf.geometry_df(mesh.coords, mesh.elems, ref)
        raw = np.load(_DATA)
        hier = mgm.build_hierarchy(
            raw["coords"].astype(np.float32), raw["elems"], level, _free_fn
        )
        fmap0_np, n_free0 = asm.free_dof_map(np.asarray(hier[0].free))
        s0_hi, s0_lo = adf.split_f64_np(s0)
        tab32 = tables(ref)
        tab32 = type(tab32)(*[jnp.asarray(x, f32) for x in tab32])
        args = dict(
            B_hi=gdf.hi.B, w_hi=gdf.hi.weight,
            edofs=gdf.hi.edofs, edofs_t=gdf.hi.edofs_t,
            B_lo=gdf.B_lo, w_lo=gdf.w_lo, gmap=gdf.gmap,
            free_mask=jnp.asarray(mesh.free),
            s0_hi=jnp.asarray(s0_hi), s0_lo=jnp.asarray(s0_lo),
            free_idx0=jnp.asarray(
                np.nonzero(np.asarray(hier[0].free).reshape(-1))[0]
            ),
        )
        n_nodes, n_q, n_real = mesh.n_nodes, gdf.hi.n_q, gdf.hi.n_real

        # hoisted MG build (one jitted setup program; see multigrid
        # mg_level_arrays) — not recomputed in every IR-pass dispatch
        d_fn = lambda gg: elastic_tangent_lanes(shear, bulk, gg.n_int, f32)

        def _build_mg(h, t, fmap0):
            levels = mgm.build_mg_levels(h, t, d_fn)
            arrays, _ = mgm.mg_level_arrays(levels)
            lev0 = levels[0]
            K0 = asm.assemble_dense_free(
                asm.element_stiffness(lev0.geom, lev0.d),
                lev0.geom, fmap0, n_free0,
            )
            c0, _ = jax.scipy.linalg.cho_factor(K0)
            return arrays, c0

        args["mg_arrays"], args["cho0"] = jax.jit(_build_mg)(
            hier, tab32, jnp.asarray(fmap0_np)
        )
        mg_static = [
            (int(h.coords.shape[0]), n_q, int(h.elems.shape[0]))
            for h in hier
        ]
        t_setup = time.perf_counter() - t0

        def geom_of(a):
            return adf.GeometryDF(
                hi=asm.Geometry(
                    B=a["B_hi"], weight=a["w_hi"], edofs=a["edofs"],
                    edofs_t=a["edofs_t"], n_nodes=n_nodes, n_q=n_q,
                    n_real=n_real,
                ),
                B_lo=a["B_lo"], w_lo=a["w_lo"], gmap=a["gmap"],
            )

        # one dispatch per IR pass
        @jax.jit
        def ir_pass(a, u_hi, u_lo):
            g = geom_of(a)
            n_int = g.hi.n_int
            bc = lambda x: jnp.broadcast_to(x[:3, None], (3, n_int))
            f0 = adf.internal_force_df(g, DF(bc(a["s0_hi"]), bc(a["s0_lo"])))
            D = elastic_tangent_lanes(shear, bulk, n_int, f32)

            mg_levels = mgm.mg_levels_from_arrays(a["mg_arrays"], mg_static)
            idx0 = a["free_idx0"]

            def coarse_solve(r):
                return jnp.zeros_like(r).at[idx0].set(
                    jax.scipy.linalg.cho_solve((a["cho0"], False), r[idx0])
                )

            pre = mgm.make_vcycle(mg_levels, coarse_solve, nu=2)
            u = DF(u_hi, u_lo)
            r = adf.df_add(
                DF(-f0.hi, -f0.lo),
                DF(*map(jnp.negative, adf.elastic_apply_df(g, u, shear, bulk))),
            )
            res = solve_cg(
                lambda v: asm.tangent_matvec(g.hi, D, v),
                r.hi, a["free_mask"], precond=pre,
                tol=2e-7, maxiter=16, structure="scan",
            )
            u = adf.df_add(u, DF(res.x, jnp.zeros_like(res.x)))
            return u.hi, u.lo, res.iters

        def run(a):
            u_hi = jnp.zeros((2 * n_nodes,), f32)
            u_lo = jnp.zeros((2 * n_nodes,), f32)
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
            "n_elems": int(mesh.n_elems),
            "n_dofs": int(2 * mesh.n_nodes),
            "wall_s": wall,
            "setup_s": t_setup,
            "compile_plus_first_s": t_first,
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
    lv = tuple(int(x) for x in sys.argv[1:]) or (0, 1, 2, 3, 4)
    run_elastic_df32_sweep(levels=lv)
