"""Elastic-assembly refinement sweep (component #22 analog).

The reference timed `get_elastic_stiffness_matrix` over 8 MATLAB uniform
refinements (`comparison_assembly_P1_2D_elasticity.py:44-85`).  Here: the
tsx mesh is red-refined level by level and the *full elastic operator
application pipeline* (geometry + element stiffness + nodal scatter of
K.u) is timed on device, reporting wall-clock and GDOF/s.

All arrays pass through jit arguments (utils/jitsafe.py).
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np


def run_assembly_sweep(
    levels: int = 5, reps: int = 5, verbose: bool = True
) -> List[dict]:
    import jax
    import jax.numpy as jnp

    from ..mesh.refine import refine_uniform
    from ..models.materials import elastic_tangent_lanes, lame_moduli
    from ..models.tsx_tunnel import tsx_mesh
    from ..ops import assembly as asm
    from ..ops.elements import ElementType, tables, volume_element
    from ..utils.timing import time_jitted

    G, K = lame_moduli(60000.0, 0.2)
    ref = volume_element(ElementType.P1)
    mesh0 = tsx_mesh(ElementType.P1)
    coords, elems = mesh0.coords, mesh0.elems

    # The whole assemble+apply pipeline runs `inner` times per dispatch in
    # an on-device dependence chain, so the dispatch cost is amortized
    # over `inner` pipeline executions.
    inner = 10

    @jax.jit
    def assemble_and_apply(a):
        def body(_, u):
            # couple coords to the iterate through a RUNTIME zero so the
            # geometry/stiffness stages cannot be hoisted out of the loop
            # (a literal 0.0*x would be folded away on this toolchain)
            c2 = a["coords"] + a["zc"] * u[0]
            geom = asm.compute_geometry(c2, a["elems"], a["tab"])
            D = elastic_tangent_lanes(G, K, geom.n_int, c2.dtype)
            ke = asm.element_stiffness(geom, D)
            f = asm.tangent_matvec(geom, D, u)
            return f / (1.0 + jnp.abs(f).max()) + a["zc"] * ke.sum()

        return jax.lax.fori_loop(0, inner, body, a["u"])

    results = []
    for level in range(levels + 1):
        if level > 0:
            coords, elems = refine_uniform(coords, elems)
        n_n = coords.shape[0]
        n_e = elems.shape[0]
        a = dict(
            coords=jnp.asarray(coords),
            elems=jnp.asarray(elems),
            tab=tables(ref),
            u=jnp.ones(2 * n_n),
            zc=jnp.zeros(()),
        )
        wall = time_jitted(assemble_and_apply, a, reps=reps) / inner
        rec = {
            "level": level,
            "n_elems": int(n_e),
            "n_dofs": int(2 * n_n),
            "assemble_apply_s": wall,
            "gdof_per_s": 2 * n_n / wall / 1e9,
        }
        results.append(rec)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    run_assembly_sweep()
