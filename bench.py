"""Benchmark: full TSX-tunnel Drucker-Prager Newton solve on the accelerator.

North-star metric (BASELINE.json): wall-clock of the complete load-stepped
Newton solve on the tsx-tunnel P1 mesh.  Baseline: the unmodified
NumPy/SciPy reference takes 1.36 s on the container CPU (BASELINE.md,
measured); `vs_baseline` is the speedup over that.

Path benchmarked: the double-float (df32) fast path — every hot op in f32,
the Newton residual/criterion/state in two-f32 pairs — which reproduces
the f64 parity trajectory (17 steps / 28 Newton iterations) and matches
the f64 displacement field to ~5e-14 relative (see solve/newton.py).
Correctness is asserted before timing (a fast wrong answer doesn't count).

Also emitted: operator throughputs on the level-4 refined mesh (227k
elements) — the assembled slot matvec (the production operator), element
stiffness assembly, the lane-major return map and the matrix-free matvec —
each timed as an on-device `fori_loop` chain.  Every wall is synced with
`jax.block_until_ready`.  The record names the device it ran on; no peak
rate is assumed for it.
"""
from __future__ import annotations

import json
import subprocess
import time

BASELINE_WALL_S = 1.36  # reference tsx P1 solve, container CPU (BASELINE.md)
# final monitored displacement of this repo's f64 parity path (fixed
# ep-accumulation semantics; the raw reference's value is -1.979449671e-03
# under its Ep-reset quirk — see PARITY.md)
ANCHOR_U40_F64 = -1.9794499636012143e-03


def _bench_solve(jax, np):
    from fem_elastoplasticity_tpu.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu.models.config import TsxTunnelConfig

    # assembled_cg on the dense solver = assembled df32 G/S residual
    # operators (ops/spmv.py build_residual_slot_df)
    cfg = TsxTunnelConfig.fast(assembled_cg=True)
    run, args, mesh = tsx.build_df32(cfg)

    # warmup + correctness gate
    res = run(args)
    u40 = float(np.asarray(res.u.hi, np.float64)[2 * cfg.monitor_node]) + float(
        np.asarray(res.u.lo, np.float64)[2 * cfg.monitor_node]
    )
    rel_err = abs(u40 - ANCHOR_U40_F64) / abs(ANCHOR_U40_F64)
    assert int(res.n_steps) == 17, f"step count {int(res.n_steps)} != 17"
    assert int(res.n_newton_total) == 28, (
        f"newton iterations {int(res.n_newton_total)} != 28"
    )
    assert rel_err < 1e-9, u40

    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        jax.block_until_ready(run(args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), rel_err, [float(t) for t in times]


def _l4_problem():
    import jax.numpy as jnp

    from fem_elastoplasticity_tpu.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu.models.materials import lame_moduli
    from fem_elastoplasticity_tpu.models.tsx_tunnel import tsx_mesh
    from fem_elastoplasticity_tpu.ops.elements import tables, volume_element

    cfg = TsxTunnelConfig(refine_levels=4)  # 227k elements / 228k DOFs
    mesh = tsx_mesh(cfg.etype, cfg.refine_levels)
    ref = volume_element(cfg.etype)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    tab = tables(ref)
    tab = type(tab)(*[jnp.asarray(x, jnp.float32) for x in tab])
    return cfg, mesh, ref, shear, bulk, tab


def _bench_matvec_matrixfree(jax, np):
    """Matrix-free elastic K*u on the level-4 mesh: GDOF/s."""
    import jax.numpy as jnp

    from fem_elastoplasticity_tpu.benchmarks.spmv_bench import chain_time
    from fem_elastoplasticity_tpu.models.materials import elastic_tangent_lanes
    from fem_elastoplasticity_tpu.ops import assembly as asm

    cfg, mesh, ref, shear, bulk, tab = _l4_problem()
    f32 = jnp.float32
    args = dict(
        coords=jnp.asarray(mesh.coords, f32),
        elems=jnp.asarray(mesh.elems),
        tab=tab,
    )

    def step(v, a):
        geom = asm.compute_geometry(a["coords"], a["elems"], a["tab"])
        D = elastic_tangent_lanes(shear, bulk, geom.n_int, f32)
        w = asm.tangent_matvec(geom, D, v)
        return w / (1.0 + jnp.abs(w).max())  # keep values bounded

    _, wall = chain_time(step, jnp.ones((2 * mesh.n_nodes,), f32), args)
    return 2 * mesh.n_nodes / wall / 1e9


def _bench_assembled_matvec(jax, np):
    """Assembled compacted-slot elastic K*u at level 4 (the production
    operator for large-mesh solves, ops/spmv.py build_slot): GDOF/s."""
    import jax.numpy as jnp

    from fem_elastoplasticity_tpu.benchmarks.spmv_bench import chain_time
    from fem_elastoplasticity_tpu.ops import spmv

    cfg, mesh, ref, shear, bulk, _ = _l4_problem()
    order = spmv.rcm_node_order(np.asarray(mesh.elems), mesh.n_nodes)
    c2, e2, _ = spmv.permute_mesh(
        np.asarray(mesh.coords), np.asarray(mesh.elems), order
    )
    arrays, meta, _ = spmv.build_ell_elastic(
        c2, e2, ref, shear, bulk, fmt="slot"
    )

    def step(x, a):
        w = spmv.sp_matvec(a, meta, x)
        return w / (1.0 + jnp.abs(w).max())

    _, wall = chain_time(
        step, jnp.ones((meta.n2,), jnp.float32), arrays, reps=100
    )
    return meta.n2 / wall / 1e9


def _bench_assembly_throughput(jax, np):
    """Per-element stiffness assembly (ops/assembly.py element_stiffness —
    the batched B^T D B einsum over all integration points) on the level-4
    mesh.  Reported as mesh DOFs assembled per second."""
    import jax.numpy as jnp

    from fem_elastoplasticity_tpu.benchmarks.spmv_bench import chain_time
    from fem_elastoplasticity_tpu.models.materials import elastic_tangent_lanes
    from fem_elastoplasticity_tpu.ops import assembly as asm

    cfg, mesh, ref, shear, bulk, tab = _l4_problem()
    f32 = jnp.float32
    args = dict(
        coords=jnp.asarray(mesh.coords, f32),
        elems=jnp.asarray(mesh.elems),
        tab=tab,
    )

    def step(c, a):
        geom = asm.compute_geometry(a["coords"], a["elems"], a["tab"])
        D = elastic_tangent_lanes(shear, bulk, geom.n_int, f32)
        # scale D by a bounded function of the previous result so
        # iterations chain (no CSE), like the real solver's
        # per-Newton-iteration tangent reassembly
        ke = asm.element_stiffness(geom, D * c)
        return 1.0 + 1e-30 * jnp.abs(ke[0, 0, 0])

    _, wall = chain_time(step, jnp.asarray(1.0, f32), args)
    return 2 * mesh.n_nodes / wall / 1e9


def _bench_return_map_throughput(jax, np):
    """The lane-major Drucker-Prager constitutive update
    (models/materials.py dp_return_map_lanes, f32) over the level-4
    integration-point stream.  Reported both as mesh DOFs per second (the
    BASELINE.md unit) and integration points per second."""
    import jax.numpy as jnp

    from fem_elastoplasticity_tpu.benchmarks.spmv_bench import chain_time
    from fem_elastoplasticity_tpu.models.materials import (
        dp_return_map_lanes,
        drucker_prager_fit,
    )

    cfg, mesh, ref, shear, bulk, _ = _l4_problem()
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    n = mesh.n_elems  # P1: 1 integration point per element
    f32 = jnp.float32
    rng = np.random.default_rng(0)
    e3 = jnp.asarray(1e-3 * rng.standard_normal((3, n)), f32)

    def step(e3, ep):
        s, *_ = dp_return_map_lanes(e3, ep, shear, bulk, eta, c)
        # feed the stress back as a bounded strain so iterations truly
        # chain; the map is branchless, so cost does not depend on values
        return s[:3] / (1.0 + jnp.abs(s).max())

    _, wall = chain_time(step, e3, jnp.zeros((4, n), f32), reps=200)
    return 2 * mesh.n_nodes / wall / 1e9, n / wall / 1e9


def _device_record(jax) -> dict:
    devs = jax.devices()
    try:
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        gpu = None
    return dict(
        platform=devs[0].platform, kind=devs[0].device_kind,
        count=len(devs), name_power_limit=gpu,
    )


def main() -> None:
    """Run all measurements and print the result JSON."""
    import jax
    import numpy as np

    import fem_elastoplasticity_tpu  # noqa: F401  (enables x64 + precision policy)
    from fem_elastoplasticity_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    wall, rel_err, walls = _bench_solve(jax, np)
    ell_gdof_s = _bench_assembled_matvec(jax, np)
    asm_gdof_s = _bench_assembly_throughput(jax, np)
    rm_gdof_s, rm_gipts_s = _bench_return_map_throughput(jax, np)
    gdof_s = _bench_matvec_matrixfree(jax, np)

    print(
        json.dumps(
            {
                "metric": "tsx_tunnel_p1_dp_newton_solve_wall",
                "value": wall,
                "unit": "s",
                "vs_baseline": BASELINE_WALL_S / wall,
                "precision": "df32_fast_path",
                "rel_err_vs_f64_trajectory": rel_err,
                "walls_s": walls,
                "device": _device_record(jax),
                # north-star throughputs (BASELINE.md metric line), all
                # on the level-4 mesh (227k elements / 228k DOFs).  The
                # assembled slot matvec is the PRODUCTION operator.
                "gdof_per_s_assembly_l4": asm_gdof_s,
                "gdof_per_s_return_map_l4": rm_gdof_s,
                "gipts_per_s_return_map_l4": rm_gipts_s,
                "gdof_per_s_assembled_matvec_l4": ell_gdof_s,
                # diagnostic only: the UNASSEMBLED matrix-free matvec
                "gdof_per_s_matvec_matrixfree_l4_diag": gdof_s,
            }
        )
    )


if __name__ == "__main__":
    main()
