"""TSX tunnel excavation (Drucker-Prager, unstructured mesh).

Drop-in analog of the reference driver `tsx-tunnel/sandbox.py`
(`elasticity_fem(P4, level=1)`), plus the extras: the f32 / df32 fast
paths, multi-device sharding and mesh refinement.

    python examples/tsx_tunnel.py --etype P1 --draw
    python examples/tsx_tunnel.py --etype P4 --solver cg
    python examples/tsx_tunnel.py --fast            # df32 fast path
    python examples/tsx_tunnel.py --fast --solver mg --refine 3   # 57k DOFs
    python examples/tsx_tunnel.py --support 2.0     # 2 MPa tunnel support
    python examples/tsx_tunnel.py --devices 4       # shard_map over 4 GPUs
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--etype", default="P1", choices=["P1", "P2", "P4"])
    p.add_argument("--refine", type=int, default=0, help="uniform refinements")
    p.add_argument("--solver", default="dense", choices=["dense", "cg", "mg"])
    p.add_argument("--fast", action="store_true", help="df32 fast path")
    p.add_argument(
        "--support", type=float, default=0.0,
        help="tunnel support pressure (MPa) on the wall (beyond-reference)",
    )
    p.add_argument("--devices", type=int, default=0, help="shard over N devices")
    p.add_argument("--draw", action="store_true")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from fem_elastoplasticity_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    import numpy as np

    from fem_elastoplasticity_tpu.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu.models.tsx_tunnel import (
        solve,
        solve_sharded,
        solve_sharded_df32,
    )
    from fem_elastoplasticity_tpu.ops.elements import ElementType

    kw = dict(
        etype=ElementType[args.etype],
        refine_levels=args.refine,
        solver=args.solver,
        support_pressure=args.support,
    )
    cfg = TsxTunnelConfig.fast(**kw) if args.fast else TsxTunnelConfig(**kw)

    if args.devices and args.fast:
        # multi-chip df32: element-sharded fast path with the exact
        # compensated all-reduce (requires solver="cg")
        import dataclasses

        cfg = dataclasses.replace(cfg, solver="cg")
        res = solve_sharded_df32(cfg, n_devices=args.devices)
    elif args.devices:
        res = solve_sharded(cfg, n_devices=args.devices)
    else:
        res = solve(cfg)

    print(f"accepted steps: {res.n_steps}")
    print(f"Newton iterations: {res.n_newton_total}")
    print(f"yielded integration points: {res.n_plastic}")
    print(f"tunnel-wall displacement u_x(node 40): {float(res.u[40, 0]):.9e}")

    if args.draw:
        from fem_elastoplasticity_tpu import viz

        u = np.asarray(res.u)
        viz.draw_mesh(res.mesh, show=False)
        viz.plot_load_curve(
            np.asarray(res.zeta_hist), np.asarray(res.displ_hist), res.n_steps,
            show=False,
        )
        u_total = np.sqrt((u**2).sum(axis=1))
        viz.draw_quantity(res.mesh, 300 * u, u_total, outline="tsx")


if __name__ == "__main__":
    main()
