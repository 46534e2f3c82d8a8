"""Smoke test of the solvers on the GPU.

    python chip_smoke.py              # every default phase, one GPU
    python chip_smoke.py --devices 4  # the sharded paths on four GPUs

Drives the main paths through their normal entry points
(`models.elasticity.solve`, `models.tsx_tunnel.solve` / `build_df32`,
`models.footing.solve` / `build_df32`) and checks each against a plain
reference:

  parity     the reference anchors: elasticity P1 L1 energy, the tsx
             native-f64 dense solve (17 steps / 28 Newton iterations /
             u40), the df32 assembled-residual fast path against the same
             anchor, and the df32 residual floor under one jit on the card;
  operators  every assembled sparse operator at the L5 width (910k DOFs)
             against a SciPy f64 CSR matvec of the same matrix, the
             smoother sweep against a NumPy block-Jacobi sweep, and the
             f32 return map against f64; then each hot operator's time;
  scale      the full 17-step tsx excavation at L5 (fast_scale) against
             the native-f64 matrix-free multigrid path at L5;
  footing    the footing tangent multigrid (fast_scale L3) against the
             native-f64 block-Jacobi CG footing, truncated ramp;
  multi      (--devices N only) the row-sharded fast_scale excavation,
             the sharded footing and the element-sharded parity solves on
             N GPUs against one GPU.

Each phase prints one JSON line (wall seconds, solver counts, peak device
memory, device kind, card name and power limit).  A failed gate exits
non-zero, as does a backend other than the GPU: nothing falls back to the
CPU.  The last line is the run's verdict,
{"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

U40_F64 = -1.9794499636012143e-03  # tsx P1 f64 anchor (bench.py, PARITY.md)
ENERGY_P1_L1 = 2786.3472189077     # elasticity P1 L1 stored energy
TSX_STEPS, TSX_NEWTON = 17, 28


def gpu_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (one card per line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def result_line(devices) -> dict:
    """The verdict line's object, for the devices the run used."""
    return {
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }


def _rel(a, b) -> float:
    """max |a - b| / max |b| in f64."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


class Phase:
    """Collects one phase's walls, counts and gates into its JSON line."""

    def __init__(self, name: str):
        self.rec = {"phase": name, "ok": True, "setup_s": 0.0,
                    "compile_s": 0.0, "warm_s": 0.0, "checks": {}}

    def walls(self, setup=0.0, first=None, warm=None):
        """Add set-up and run walls.  With both `first` and `warm`, the
        first call minus the warm call counts as compile time; a single
        call's wall counts as compile (it includes it)."""
        self.rec["setup_s"] += setup
        if first is not None and warm is not None:
            self.rec["compile_s"] += max(first - warm, 0.0)
            self.rec["warm_s"] += warm
        elif first is not None:
            self.rec["compile_s"] += first

    def check(self, name, value, limit, op="<="):
        """Gate `value op limit`; a failed gate fails the phase."""
        ok = {"<=": value <= limit, "==": value == limit}[op]
        self.rec["checks"][name] = {"value": value, "limit": limit,
                                    "op": op, "ok": bool(ok)}
        self.rec["ok"] &= bool(ok)

    def info(self, **kw):
        self.rec.update(kw)

    def close(self, devices, gpu: str) -> dict:
        peak = [d.memory_stats().get("peak_bytes_in_use", 0)
                for d in devices]
        self.rec.update(peak_bytes_in_use=max(peak),
                        device_kind=devices[0].device_kind, gpu=gpu)
        return self.rec


def _df_u40(res, extras, cfg, mesh):
    from fem_elastoplasticity_tpu.models import tsx_tunnel as tsx

    r = tsx._df32_result(res, extras, cfg, mesh)
    return r, float(r.u[cfg.monitor_node, 0])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_parity(ph: Phase):
    import numpy as np

    import jax
    import jax.numpy as jnp

    from fem_elastoplasticity_tpu.models import elasticity
    from fem_elastoplasticity_tpu.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu.models.config import (
        ElasticityConfig,
        TsxTunnelConfig,
    )

    r, t = _timed(lambda: elasticity.solve(ElasticityConfig()))
    ph.walls(first=t)
    ph.check("elasticity_p1_l1_energy_rel",
             abs(float(r.energy) - ENERGY_P1_L1) / ENERGY_P1_L1, 1e-10)

    cfg = TsxTunnelConfig()
    r64, t = _timed(lambda: tsx.solve(cfg))
    ph.walls(first=t)
    ph.check("tsx_f64_steps", int(r64.n_steps), TSX_STEPS, "==")
    ph.check("tsx_f64_newton", int(r64.n_newton_total), TSX_NEWTON, "==")
    ph.check("tsx_f64_u40_rel",
             abs(float(r64.u[40, 0]) - U40_F64) / abs(U40_F64), 1e-9)

    cfg = TsxTunnelConfig.fast(assembled_cg=True)
    extras: dict = {}
    t0 = time.perf_counter()
    run, args, mesh = tsx.build_df32(cfg, extras=extras)
    setup = time.perf_counter() - t0
    _, first = _timed(run, args)
    res, warm = _timed(run, args)
    ph.walls(setup, first, warm)
    _, u40 = _df_u40(res, extras, cfg, mesh)
    ph.check("tsx_df32_steps", int(res.n_steps), TSX_STEPS, "==")
    ph.check("tsx_df32_newton", int(res.n_newton_total), TSX_NEWTON, "==")
    ph.check("tsx_df32_u40_rel", abs(u40 - U40_F64) / abs(U40_F64), 1e-9)

    # the df32 residual at the converged f64 state, one jit (the
    # pipeline of tests/test_df32.py::TestJitPipelineExactness): a
    # compiler that contracts or reassociates across the compensated
    # stages lifts it from ~1e-12 to the f32 level, ~1e-6
    from fem_elastoplasticity_tpu.models import materials_df as mdf
    from fem_elastoplasticity_tpu.models.materials import (
        drucker_prager_fit,
        lame_moduli,
    )
    from fem_elastoplasticity_tpu.ops import assembly_df as adf
    from fem_elastoplasticity_tpu.ops import df32 as d
    from fem_elastoplasticity_tpu.ops.elements import volume_element

    cfg = TsxTunnelConfig()
    mesh = tsx.tsx_mesh(cfg.etype)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    _, e0 = tsx.initial_state(cfg)
    gdf = adf.geometry_df(mesh.coords, mesh.elems, volume_element(cfg.etype))
    free_idx = jnp.asarray(np.nonzero(mesh.free.reshape(-1))[0])
    e0_hi, e0_lo = adf.split_f64_np(e0)

    def residual(u, ep, e0z, pinz):
        u = d.df_pin(u, pinz)
        ep = d.df_pin(ep, pinz)
        e = adf.strains_df(gdf, u)
        s, _, _, _, _ = mdf.dp_return_map_lanes_df(
            e, ep, shear, bulk, eta, c, e0=e0z
        )
        f = adf.internal_force_df(gdf, d.DF(s.hi[:3], s.lo[:3]))
        return jnp.abs(f.hi[free_idx]).max()

    u_df = d.df(jnp.asarray(np.asarray(r64.u).reshape(-1)))
    ep_df = d.df(jnp.asarray(np.asarray(r64.ep)))
    e0z = d.df_mul(
        d.DF(jnp.asarray(e0_hi), jnp.asarray(e0_lo)), d.df_const(1.0)
    )
    pinz = jnp.zeros((4 * gdf.hi.n_int,), jnp.float32)
    ph.check("df32_residual_floor_eager",
             float(residual(u_df, ep_df, e0z, pinz)), 5e-12)
    ph.check("df32_residual_floor_jit",
             float(jax.jit(residual)(u_df, ep_df, e0z, pinz)), 5e-12)


# Tolerances of the operator checks, each with its reason:
#   f32 forms     1e-5: a sum of ~18 f32 products per row, in the GPU's
#                 summation order (a gather, a multiply and a reduce — no
#                 matmul, so TF32 never enters);
#   df32 forms    1e-12: the double-float floor (~1e-14) with margin for
#                 the reduction order, far below f32's ~1e-7;
#   bf16 stream   1e-2: the values are rounded to bf16 (8-bit mantissa,
#                 ~4e-3 relative), the products and sums stay f32;
#   sweep         1e-5: the f32 operator against the f64 NumPy sweep;
#   return map    1e-5: the f32 lanes against f64 lanes, as in the tests.
TOL_F32, TOL_DF, TOL_BF16, TOL_SWEEP, TOL_RM = 1e-5, 1e-12, 1e-2, 1e-5, 1e-5


def phase_operators(ph: Phase, level: int = 5):
    import numpy as np

    import jax
    import jax.numpy as jnp

    from fem_elastoplasticity_tpu.benchmarks import spmv_bench
    from fem_elastoplasticity_tpu.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu.models.materials import (
        dp_return_map_lanes,
        drucker_prager_fit,
        lame_moduli,
    )
    from fem_elastoplasticity_tpu.ops import spmv

    t0 = time.perf_counter()
    built = spmv_bench.elastic_operator(level)
    arrays, meta, K, free, n_int = built
    for u in (spmv._RAGGED_U, 8, 4):  # the smallest chunk that compacts
        a_rs, m_rs = spmv.build_slot(K, ragged=True, u=u)
        if m_rs.n_ch:
            break
    a_ell, m_ell = spmv.build_ell(K)
    a_df, m_df = spmv.build_slot_df(K)
    a_rdf, m_rdf = spmv.build_slot_df(K, ragged=True, u=m_rs.u or 16)
    a_edf, m_edf = spmv.build_ell_df(K)
    pk = spmv.pack_slot_bf16(arrays, meta)
    inv, aux = spmv_bench.block_jacobi_aux(K, free, meta)
    ph.walls(setup=time.perf_counter() - t0)
    ph.info(level=level, n_dofs=int(K.shape[0]), nnz=int(K.nnz),
            s_pad=int(meta.s_pad), ragged_chunks=int(m_rs.n_ch),
            ell_window=int(m_ell.J), ell_overflow=int(m_ell.n_overflow))

    rng = np.random.default_rng(0)
    n = K.shape[0]
    v64 = rng.standard_normal(n)
    v32 = v64.astype(np.float32)
    y32 = K @ v32.astype(np.float64)
    y64 = K @ v64
    vj = jnp.asarray(v32)
    hi = v64.astype(np.float32)
    lo = (v64 - hi.astype(np.float64)).astype(np.float32)
    hj, lj = jnp.asarray(hi), jnp.asarray(lo)

    def run(fn, *args):
        fn = jax.jit(fn)
        out, first = _timed(fn, *args)
        _, warm = _timed(fn, *args)
        ph.walls(first=first, warm=warm)
        return out

    f32_ops = [
        ("slot_matvec", arrays, meta),
        ("slot_matvec_ragged", a_rs, m_rs),
        ("ell_matvec", a_ell, m_ell),
    ]
    for name, a, m in f32_ops:
        y = run(lambda a_, v_, m=m: spmv.sp_matvec(a_, m, v_), a, vj)
        ph.check(name, _rel(y, y32), TOL_F32)
    y = run(lambda a_, v_: spmv.slot_matvec(a_, meta, v_), pk, vj)
    ph.check("slot_matvec_bf16", _rel(y, y32), TOL_BF16)

    for name, a, m in [
        ("slot_matvec_df", a_df, m_df),
        ("slot_matvec_df_ragged", a_rdf, m_rdf),
        ("ell_matvec_df", a_edf, m_edf),
    ]:
        oh, ol = run(
            lambda a_, h_, l_, m=m: spmv.sp_matvec_df(a_, m, h_, l_),
            a, hj, lj,
        )
        got = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
        ph.check(name, _rel(got, y64), TOL_DF)

    # smoother sweep vs NumPy damped block Jacobi:
    # z' = z + mask * inv (mask * (r - K z)), per 2x2 node block
    z64 = rng.standard_normal(n).astype(np.float32).astype(np.float64)
    r64 = rng.standard_normal(n).astype(np.float32).astype(np.float64)
    mask = free.astype(np.float64)
    res_ref = mask * (r64 - K @ z64)
    upd = np.einsum("nij,nj->ni", inv, res_ref.reshape(-1, 2)).reshape(-1)
    z_ref = z64 + mask * upd
    zj, rj = jnp.asarray(z64, jnp.float32), jnp.asarray(r64, jnp.float32)
    r2 = spmv.pad_rhs(rj, meta)
    for name, op, tol in [("slot_sweep", arrays, TOL_SWEEP),
                          ("slot_sweep_bf16", pk, TOL_BF16)]:
        z1 = run(lambda a_, x_, r_, au: spmv.slot_sweep(
            a_, meta, au, x_, r_), op, zj, r2, aux)
        ph.check(name, _rel(z1, z_ref), tol)
    zb = run(lambda a_, x_, r_, au: spmv.slot_sweep_b(
        a_, meta, au, x_, r_), arrays, spmv.pad_rhs(zj, meta), r2, aux)
    ph.check("slot_sweep_b", _rel(np.asarray(zb).reshape(-1)[:n], z_ref),
             TOL_SWEEP)
    res = run(lambda a_, x_, r_, au: spmv.slot_sweep(
        a_, meta, au, x_, r_, update=False), arrays, zj, r2, aux)
    ph.check("slot_sweep_residual", _rel(res, res_ref), TOL_SWEEP)

    # f32 return map at the L5 integration-point count (P1: one per
    # element) against the same lanes in f64
    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    e3 = rng.normal(0, 2e-3, (3, n_int))
    ep = rng.normal(0, 2e-4, (4, n_int))
    e0 = rng.normal(0, 1e-3, 4)

    def rmap(e3_, ep_, e0_):
        return dp_return_map_lanes(e3_, ep_, shear, bulk, eta, c, e0=e0_)

    s32, ds32, *_ = run(rmap, *(
        jnp.asarray(x, jnp.float32) for x in (e3, ep, e0)))
    s64, ds64, *_ = run(rmap, *(
        jnp.asarray(x) for x in (e3, ep, e0)))
    ph.check("dp_return_map_lanes_f32_s", _rel(s32, s64), TOL_RM)
    ph.check("dp_return_map_lanes_f32_ds", _rel(ds32, ds64), TOL_RM)

    ph.info(timings=spmv_bench.time_operators(level, built=built))


def phase_scale(ph: Phase, level: int = 5):
    from fem_elastoplasticity_tpu.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu.models.config import TsxTunnelConfig

    cfg = TsxTunnelConfig.fast_scale(level)
    extras: dict = {}
    t0 = time.perf_counter()
    run, args, mesh = tsx.build_df32(cfg, extras=extras)
    setup = time.perf_counter() - t0
    _, first = _timed(run, args)
    res, warm = _timed(run, args)
    ph.walls(setup, first, warm)
    r, u40 = _df_u40(res, extras, cfg, mesh)

    cfg64 = TsxTunnelConfig(refine_levels=level, solver="mg")
    r64, t64 = _timed(lambda: tsx.solve(cfg64))
    u40_64 = float(r64.u[cfg64.monitor_node, 0])
    ph.info(
        level=level, n_dofs=int(2 * mesh.n_nodes),
        fast_scale=dict(steps=r.n_steps, newton=r.n_newton_total,
                        cg=r.n_cg_total, u40=u40),
        native_f64_mg=dict(steps=r64.n_steps, newton=r64.n_newton_total,
                           cg=r64.n_cg_total, u40=u40_64, wall_s=t64),
        # counts recorded for this path before the port (diagnostic)
        earlier_record_steps_newton_cg=[17, 59, 917],
    )
    ph.check("steps_fast_scale", int(r.n_steps), TSX_STEPS, "==")
    ph.check("steps_native_f64", int(r64.n_steps), TSX_STEPS, "==")
    # inexact f32-preconditioned tangent solves (cg_tol 1e-5) under the
    # 1e-12 df32 Newton criterion
    ph.check("u40_rel", abs(u40 - u40_64) / abs(u40_64), 1e-7)


def phase_footing(ph: Phase, level: int = 3, zeta_max: float = 0.002):
    import numpy as np

    from fem_elastoplasticity_tpu.models import footing
    from fem_elastoplasticity_tpu.models.config import FootingConfig

    cfg = FootingConfig.fast_scale(level, zeta_max=zeta_max)
    t0 = time.perf_counter()
    run, args, mesh = footing.build_df32(cfg)
    setup = time.perf_counter() - t0
    _, first = _timed(run, args)
    res, warm = _timed(run, args)
    ph.walls(setup, first, warm)
    r = footing._package_df32(res, mesh)

    # block-Jacobi CG to 1e-14 needs more than the default 2000
    # iterations at L3 (nu = 0.48); a capped solve would count as
    # divergence and halve the step, so the reference runs uncapped
    cfg64 = FootingConfig(level=level, solver="cg", zeta_max=zeta_max,
                          newton_tol=1e-10, accept_tol=1e-8,
                          cg_maxiter=50000)
    r64, t64 = _timed(lambda: footing.solve(cfg64))
    k = int(r.n_steps) + 1  # history rows incl. the initial state
    p = np.asarray(r.pressure_hist)[:k]
    p64 = np.asarray(r64.pressure_hist)[:k]
    ph.info(
        level=level, zeta_max=zeta_max, n_dofs=int(2 * mesh.n_nodes),
        tangent_mg=dict(steps=r.n_steps, newton=r.n_newton_total,
                        cg=r.n_cg_total, pressure=float(p[-1])),
        native_f64_cg=dict(steps=r64.n_steps, newton=r64.n_newton_total,
                           cg=r64.n_cg_total, pressure=float(p64[-1]),
                           wall_s=t64),
    )
    ph.check("steps_equal", int(r.n_steps), int(r64.n_steps), "==")
    ph.check("pressure_curve_rel", _rel(p, p64), 1e-6)


def phase_multi(ph: Phase, n_dev: int, level: int = 5,
                footing_level: int = 3):
    import numpy as np

    from fem_elastoplasticity_tpu.models import footing
    from fem_elastoplasticity_tpu.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu.models.config import (
        FootingConfig,
        TsxTunnelConfig,
    )

    def both(build, cfg):
        out = []
        for shard in (None, n_dev):
            t0 = time.perf_counter()
            run, args, mesh = build(cfg, shard)
            setup = time.perf_counter() - t0
            _, first = _timed(run, args)
            res, warm = _timed(run, args)
            ph.walls(setup, first, warm)
            out.append((res, mesh))
        return out

    f64 = lambda p: np.asarray(p.hi, np.float64) + np.asarray(p.lo, np.float64)

    def compare(tag, r1, rn, tol):
        u1, un = f64(r1.u), f64(rn.u)
        ph.check(f"{tag}_steps", int(rn.n_steps), int(r1.n_steps), "==")
        ph.check(f"{tag}_newton", int(rn.n_newton_total),
                 int(r1.n_newton_total), "==")
        ph.check(f"{tag}_u_rel", _rel(un, u1), tol)
        ph.info(**{f"{tag}_bit_identical": bool(np.array_equal(un, u1)),
                   f"{tag}_counts": [int(rn.n_steps), int(rn.n_newton_total),
                                     int(rn.n_cg_total)]})

    # the dense slot residual layout on both sides: row sharding needs
    # it, and one layout keeps the comparison like for like
    cfg = TsxTunnelConfig.fast_scale(level, residual_fmt="slot")
    (r1, _), (rn, _) = both(
        lambda c, s: tsx.build_df32(c, shard_devices=s), cfg)
    compare("tsx_fast_scale", r1, rn, 1e-10)

    cfg = FootingConfig.fast_scale(footing_level, zeta_max=0.002)
    (r1, _), (rn, _) = both(
        lambda c, s: footing.build_df32(c, shard_devices=s), cfg)
    compare("footing_fast_scale", r1, rn, 1e-10)

    # element-sharded parity-size solves
    t0 = time.perf_counter()
    ref = tsx.solve(TsxTunnelConfig(solver="cg"))
    sh = tsx.solve_sharded(TsxTunnelConfig(), n_devices=n_dev)
    ph.check("solve_sharded_steps", int(sh.n_steps), int(ref.n_steps), "==")
    ph.check("solve_sharded_u_abs", float(np.abs(
        np.asarray(sh.u) - np.asarray(ref.u)).max()), 1e-14)
    cfg = TsxTunnelConfig.fast(solver="cg")
    ref = tsx.solve(cfg)
    sh = tsx.solve_sharded_df32(cfg, n_devices=n_dev)
    ph.check("solve_sharded_df32_steps", int(sh.n_steps), int(ref.n_steps),
             "==")
    ph.check("solve_sharded_df32_u_rel", _rel(sh.u, ref.u), 1e-12)
    ph.walls(first=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: the default phases on one GPU; N > 1: only "
                    "the sharded phase on N GPUs")
    opts = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{devices[0].platform!r}); nothing is run on the CPU",
              file=sys.stderr)
        return 2
    if len(devices) < opts.devices:
        print(f"chip_smoke: {opts.devices} GPUs requested, "
              f"{len(devices)} found", file=sys.stderr)
        return 2
    devices = devices[: opts.devices]

    import fem_elastoplasticity_tpu  # noqa: F401  (x64 + precision policy)
    from fem_elastoplasticity_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    gpu = gpu_name_power()
    if opts.devices > 1:
        plan = [("multi", lambda ph: phase_multi(ph, opts.devices))]
    else:
        plan = [("parity", phase_parity), ("operators", phase_operators),
                ("scale", phase_scale), ("footing", phase_footing)]
    ok = True
    for name, fn in plan:
        ph = Phase(name)
        fn(ph)
        rec = ph.close(devices, gpu)
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
    if not ok:
        print("chip_smoke: a phase failed its gates", file=sys.stderr)
        return 1
    print(gpu)
    print(json.dumps(result_line(devices)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
