"""Linear elasticity on the square-with-hole domain.

Drop-in analog of the reference driver `Elasticity2D/sandbox.py`
(`elasticity_fem(Q2, level=1)`), with the same knobs exposed as CLI flags.

    python examples/elasticity2d.py --etype Q2 --level 1 --draw
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--etype", default="Q2", choices=["P1", "P2", "Q1", "Q2"])
    p.add_argument("--level", type=int, default=1)
    p.add_argument("--draw", action="store_true")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from fem_elastoplasticity_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from fem_elastoplasticity_tpu.models.config import ElasticityConfig
    from fem_elastoplasticity_tpu.models.elasticity import solve
    from fem_elastoplasticity_tpu.ops.elements import ElementType

    cfg = ElasticityConfig(etype=ElementType[args.etype], level=args.level)
    res = solve(cfg)
    print(f"Stored energy: {float(res.energy)}")  # reference E:1172 printout

    if args.draw:
        import numpy as np

        from fem_elastoplasticity_tpu import viz

        u = np.asarray(res.u)
        viz.draw_mesh(res.mesh, show=False)
        viz.draw_displacement(res.mesh, u)


if __name__ == "__main__":
    main()
