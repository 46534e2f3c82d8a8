"""Scaling sweep: the BASELINE "10k -> 1M elements" config.

Per refinement level of the tsx mesh, times the two single-jit programs
that dominate the adaptive solve:

  * `elastic_cg`  — the full matrix-free block-Jacobi CG solve of the
    elastic excavation predictor K u = -F0 (a complete linear solve at
    1e-12 relative tolerance), and
  * `newton_iter` — one semi-smooth Newton iteration: strains -> DP return
    map -> internal force -> CG tangent solve.

This is the honest analog of the reference's "long-context scaling" axis
(SURVEY.md §2.4): memory-bound gather/scatter and reductions growing with
mesh size.  The small-mesh *full adaptive solves* are covered by bench.py
and the test suite.
"""
from __future__ import annotations

import json
from typing import List

import numpy as np


def run_solve_sweep(
    levels=(0, 1, 2, 3), reps: int = 3, verbose=True, time_newton: bool = False,
    preconditioner: str = "mg",
) -> List[dict]:
    """preconditioner: "mg" (geometric multigrid V-cycle; mesh-independent
    iteration counts) or "jacobi" (2x2 block-Jacobi)."""
    import jax
    import jax.numpy as jnp

    from ..models.config import TsxTunnelConfig
    from ..models.materials import (
        dp_return_map_lanes,
        drucker_prager_fit,
        elastic_tangent_lanes,
        lame_moduli,
    )
    from ..models.tsx_tunnel import initial_state, tsx_mesh
    from ..ops import assembly as asm
    from ..ops.elements import ElementType, tables, volume_element
    from ..solve import multigrid as mg
    from ..solve.cg import block_jacobi_preconditioner, solve_cg
    from ..utils.timing import time_jitted

    cfg = TsxTunnelConfig()
    G, K = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    s0, e0 = initial_state(cfg)
    ref = volume_element(ElementType.P1)

    def _free_fn(coords):
        free = np.ones((coords.shape[0], 2), dtype=bool)
        free[np.abs(coords[:, 0]) > 49.99, 0] = False
        free[np.abs(coords[:, 1]) > 49.99, 1] = False
        return free

    @jax.jit
    def elastic_cg(a):
        geom = asm.compute_geometry(a["coords"], a["elems"], a["tab"])
        dtype = a["coords"].dtype
        s0f = jnp.broadcast_to(a["s0"][:3, None], (3, geom.n_int))
        f0 = asm.internal_force(geom, s0f)
        D = elastic_tangent_lanes(G, K, geom.n_int, dtype)
        if preconditioner == "mg":
            d_fn = lambda g: elastic_tangent_lanes(G, K, g.n_int, dtype)
            mg_levels = mg.build_mg_levels(a["hier"], a["tab"], d_fn)
            lev0 = mg_levels[0]
            K0 = asm.assemble_dense_free(
                asm.element_stiffness(lev0.geom, lev0.d),
                lev0.geom, a["fmap0"], a["n_free0"].shape[0],
            )
            cho = jax.scipy.linalg.cho_factor(K0)
            idx0 = a["free_idx0"]

            def coarse_solve(r):
                return jnp.zeros_like(r).at[idx0].set(
                    jax.scipy.linalg.cho_solve(cho, r[idx0])
                )

            pre = mg.make_vcycle(mg_levels, coarse_solve, nu=2)
        else:
            blocks = asm.node_block_diagonal(geom, D)
            pre = block_jacobi_preconditioner(blocks, a["free"].reshape(-1, 2))
        res = solve_cg(
            lambda v: asm.tangent_matvec(geom, D, v),
            -f0,
            a["free"],
            precond=pre,
            tol=1e-12,
            # MG iteration counts are mesh-independent (14-21 measured), so
            # the fixed-trip scan form is cheap
            maxiter=40 if preconditioner == "mg" else 1000,
            structure="scan" if preconditioner == "mg" else "while",
        )
        return res.x, res.iters

    @jax.jit
    def newton_iter(a):
        geom = asm.compute_geometry(a["coords"], a["elems"], a["tab"])
        e3 = asm.strains(geom, a["u"])
        s_, ds, _, _, _ = dp_return_map_lanes(
            e3, a["ep"], G, K, eta, c, e0=a["e0"]
        )
        f_int = asm.internal_force(geom, s_[:3])
        blocks = asm.node_block_diagonal(geom, ds)
        pre = block_jacobi_preconditioner(blocks, a["free"].reshape(-1, 2))
        res = solve_cg(
            lambda v: asm.tangent_matvec(geom, ds, v),
            -f_int,
            a["free"],
            precond=pre,
            tol=1e-12,
        )
        return a["u"] + res.x, res.iters

    results = []
    for level in levels:
        mesh = tsx_mesh(ElementType.P1, refine_levels=level)
        n_int_pad = mesh.n_elems
        while n_int_pad % asm.LANE_PAD != 0:
            n_int_pad += 1
        a = dict(
            coords=jnp.asarray(mesh.coords),
            elems=jnp.asarray(mesh.elems),
            tab=tables(ref),
            free=jnp.asarray(mesh.free),
            s0=jnp.asarray(s0),
            e0=jnp.asarray(e0),
            u=jnp.zeros(2 * mesh.n_nodes),
            ep=jnp.zeros((4, n_int_pad)),
        )
        if preconditioner == "mg":
            base = tsx_mesh(ElementType.P1)
            a["hier"] = mg.build_hierarchy(
                base.coords, base.elems, level, _free_fn
            )
            fmap0, n_free0 = asm.free_dof_map(np.asarray(a["hier"][0].free))
            a["fmap0"] = jnp.asarray(fmap0)
            a["n_free0"] = jnp.zeros((n_free0,), jnp.int8)  # static length carrier
            a["free_idx0"] = jnp.asarray(
                np.nonzero(np.asarray(a["hier"][0].free).reshape(-1))[0]
            )
        u_el, iters = jax.block_until_ready(elastic_cg(a))
        a["u"] = cfg.d_zeta * u_el
        t_cg = time_jitted(elastic_cg, a, reps=reps)
        rec = {
            "level": level,
            "n_elems": int(mesh.n_elems),
            "n_dofs": int(2 * mesh.n_nodes),
            "cg_iters": int(iters),
            "elastic_cg_s": t_cg,
            "cg_gdof_per_s": 2 * mesh.n_nodes * int(iters) / t_cg / 1e9,
        }
        if time_newton:
            # the f64 return-map + CG program; opt-in only
            rec["newton_iter_s"] = time_jitted(newton_iter, a, reps=reps)
        results.append(rec)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    run_solve_sweep()
