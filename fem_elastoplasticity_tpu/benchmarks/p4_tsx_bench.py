"""Full-schedule P4 TSX excavation benchmark (the reference's entry point).

The reference's actual driver config is `elasticity_fem(P4, level=1)`
(`tsx-tunnel/sandbox.py:4`, `tsx-tunnel/pythonFEM.py:1637`): 15-node
quartic triangles on the unstructured tunnel mesh, full excavation to
zeta = 1.  This runs it end-to-end (matrix-free CG tangent solves — the
P4 system has ~14k free DOFs) and reports wall clock + trajectory facts.

Run:  python -m fem_elastoplasticity_tpu.benchmarks.p4_tsx_bench
The f64 reference trajectory: 17 steps / 40 Newton iterations / 79
plastic points / u40 = -2.267020043e-03.
"""
from __future__ import annotations

import json
import time


def main(fast: bool = True, solver: str = "ell") -> None:
    from ..models.config import TsxTunnelConfig
    from ..models.tsx_tunnel import solve
    from ..ops.elements import ElementType

    if fast:
        # default solver="ell" = p-multigrid: the P4 node lattice equals
        # 2 red refinements of the base mesh, so the assembled P1
        # hierarchy preconditions the high-order tangent CG — measured
        # 990 -> 20 CG iterations vs block-Jacobi (models/tsx_tunnel.py).
        # --mf: matrix-free block-Jacobi cg (16.3 s warm, 2026-08-17);
        # --assembled: compacted-slot assembled tangent (34.4 s warm)
        kw = dict(etype=ElementType.P4, solver=solver)
        if solver == "cg-assembled":
            kw = dict(etype=ElementType.P4, solver="cg", assembled_cg=True)
        cfg = TsxTunnelConfig.fast(**kw)
    else:
        cfg = TsxTunnelConfig(etype=ElementType.P4, solver="cg")
    if fast:
        # reuse the built runner so the warm wall excludes host setup,
        # tracing and compile (the production serving shape)
        import jax
        import numpy as np

        from ..models.tsx_tunnel import build_df32

        run, args, mesh = build_df32(cfg)
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(args))
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(args))
        warm = time.perf_counter() - t0
        k = int(res.n_steps) - 1
        u40 = float(np.asarray(res.monitor_hist.hi, np.float64)[k]) + float(
            np.asarray(res.monitor_hist.lo, np.float64)[k]
        )
        facts = dict(
            n_steps=int(res.n_steps),
            n_newton_total=int(res.n_newton_total),
            n_plastic=int(res.n_plastic),
            u40=u40,
        )
    else:
        t0 = time.perf_counter()
        r = solve(cfg)
        warm = wall = time.perf_counter() - t0
        facts = dict(
            n_steps=r.n_steps,
            n_newton_total=r.n_newton_total,
            n_plastic=r.n_plastic,
            u40=float(r.u[40, 0]),
        )

    path = "native_cg"
    if fast:
        path = f"df32_{solver}"
    print(
        json.dumps(
            {
                "metric": "tsx_tunnel_p4_full_schedule_wall",
                "value": warm,
                "unit": "s",
                "cold_incl_compile_s": wall,
                "path": path,
                **facts,
            }
        )
    )


if __name__ == "__main__":
    import sys

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    solver = "ell"
    if "--mf" in sys.argv:
        solver = "cg"
    elif "--assembled" in sys.argv:
        solver = "cg-assembled"
    main(fast="--native" not in sys.argv, solver=solver)
