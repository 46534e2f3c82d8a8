"""Drucker-Prager strip footing (load-stepped semi-smooth Newton).

Drop-in analog of the reference driver `Plasticity2D_DP/sandbox.py`
(`elasticity_fem(P1, level=1)`).

    python examples/plasticity_dp.py --etype P1 --level 1 --draw
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--etype", default="P1", choices=["P1", "P2", "Q1", "Q2"])
    p.add_argument("--level", type=int, default=1)
    p.add_argument("--draw", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument(
        "--bug-compatible-apex",
        action="store_true",
        help="reproduce reference defect #2 bit-for-bit (SURVEY.md §2.3)",
    )
    p.add_argument(
        "--fast",
        action="store_true",
        help="double-float fast preset (f32 hardware, f64 adaptive "
        "schedule — FootingConfig.fast)",
    )
    p.add_argument(
        "--solver", default=None, choices=["dense", "cg"],
        help="tangent solver (cg = matrix-free block-Jacobi PCG, the "
        "large-mesh path)",
    )
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from fem_elastoplasticity_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    import numpy as np

    from fem_elastoplasticity_tpu.models.config import FootingConfig
    from fem_elastoplasticity_tpu.models.footing import solve
    from fem_elastoplasticity_tpu.ops.elements import ElementType

    kw = dict(
        etype=ElementType[args.etype],
        level=args.level,
        bug_compatible_apex=args.bug_compatible_apex,
    )
    if args.solver:
        kw["solver"] = args.solver
    cfg = (
        FootingConfig.fast(**kw) if args.fast else FootingConfig(**kw)
    )
    res = solve(cfg)
    print(f"accepted steps: {res.n_steps}")
    print(f"Newton iterations: {res.n_newton_total}")
    print(f"yielded integration points: {res.n_plastic}")
    z = np.asarray(res.zeta_hist)
    print("Maximal load factor was achieved." if z.max() >= 1 else "Too small load increments.")
    print("normalized footing pressure:", np.asarray(res.pressure_hist[1 : res.n_steps + 1]))

    if args.draw:
        from fem_elastoplasticity_tpu import viz

        u = np.asarray(res.u)
        u_total = np.sqrt((u**2).sum(axis=1))
        viz.draw_quantity(res.mesh, u / abs(u).max(), u_total, outline="square")


if __name__ == "__main__":
    main()
