"""Assembled-operator timings against their byte traffic.

Usage: python -m fem_elastoplasticity_tpu.benchmarks.spmv_bench [level]

Builds the tsx elastic stiffness at refinement `level` (5 = 910k DOFs,
the width the fast_scale excavation runs at) in the slot, slot-df and
bf16-smoother layouts, and times `slot_matvec`, `slot_sweep_b`,
`slot_matvec_df` and the lane-major return map `dp_return_map_lanes` at
the same integration-point count.  Each operator runs in an on-device
`fori_loop` chain, synced with `jax.block_until_ready`; the time per
application is reported beside the bytes the layout must move (values,
indices, the input vectors and the outputs) and the rate those bytes
imply.  Dividing that rate by the device's memory bandwidth gives the
operator's roofline share; this module assumes no peak.
"""
from __future__ import annotations

import json
import sys
import time


def chain_time(step, x0, args, reps: int = 20, tries: int = 3):
    """(compile_s, seconds per step) of x -> step(x, args) chained `reps`
    times on the device.  The best of `tries` timed runs is taken."""
    import jax

    fn = jax.jit(
        lambda x, a: jax.lax.fori_loop(0, reps, lambda _, y: step(y, a), x)
    )
    t0 = time.perf_counter()
    compiled = fn.lower(x0, args).compile()
    jax.block_until_ready(compiled(x0, args))
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(x0, args))
        best = min(best, time.perf_counter() - t0)
    return compile_s, best / reps


def nbytes(*arrays) -> int:
    return int(sum(a.size * a.dtype.itemsize for a in arrays))


def elastic_operator(level: int):
    """RCM-ordered, BC-masked tsx elastic stiffness at `level`: returns
    (slot arrays, SlotMeta, K_csr f64, free (2n,) bool, n_elems)."""
    import numpy as np

    from ..models.config import TsxTunnelConfig
    from ..models.materials import lame_moduli
    from ..models.tsx_tunnel import tsx_mesh
    from ..ops import spmv
    from ..ops.elements import ElementType, volume_element

    cfg = TsxTunnelConfig()
    mesh = tsx_mesh(ElementType.P1, level)
    coords, elems = np.asarray(mesh.coords), np.asarray(mesh.elems)
    order = spmv.rcm_node_order(elems, mesh.n_nodes)
    c2, e2, _ = spmv.permute_mesh(coords, elems, order)
    free2 = np.asarray(mesh.free)[order]
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    arrays, meta, K = spmv.build_ell_elastic(
        c2, e2, volume_element(ElementType.P1), shear, bulk,
        free=free2, fmt="slot",
    )
    return arrays, meta, K, free2.reshape(-1), mesh.n_elems


def block_jacobi_aux(K, free, meta, omega: float = 0.7):
    """Damped 2x2 nodal block inverses of K and their sweep constants."""
    import numpy as np

    from ..ops import spmv

    b = spmv.diag_blocks_csr(K, K.shape[0] // 2)
    det = b[:, 0, 0] * b[:, 1, 1] - b[:, 0, 1] * b[:, 1, 0]
    inv = np.stack(
        [
            np.stack([b[:, 1, 1], -b[:, 0, 1]], -1),
            np.stack([-b[:, 1, 0], b[:, 0, 0]], -1),
        ],
        -2,
    ) / det[:, None, None] * omega
    return inv, spmv.build_sweep_aux(inv, free, meta)


def time_operators(level: int = 5, reps: int = 20, built=None) -> dict:
    """Per-operator {ms, bytes, gb_per_s, compile_s} at `level`; `built`
    reuses an `elastic_operator(level)` result."""
    import numpy as np

    import jax.numpy as jnp

    from ..models.materials import (
        dp_return_map_lanes,
        drucker_prager_fit,
        lame_moduli,
    )
    from ..ops import spmv

    arrays, meta, K, free, n_int = built or elastic_operator(level)
    rng = np.random.default_rng(0)
    n = meta.n2
    f32 = jnp.float32
    eps = jnp.zeros((), f32)  # runtime zero: chains without changing x
    v = jnp.asarray(rng.standard_normal(n), f32)
    vec = 4 * n
    out = {}

    def record(name, step, x0, args, traffic):
        c_s, t = chain_time(step, x0, args, reps)
        out[name] = dict(
            ms=t * 1e3, bytes=int(traffic), gb_per_s=traffic / t / 1e9,
            compile_s=c_s,
        )

    slot_bytes = nbytes(arrays["vals"], arrays["cidx"], arrays["srow"])
    record(
        "slot_matvec",
        lambda x, a: x + a["eps"] * spmv.slot_matvec(a["op"], meta, x),
        v, dict(op=arrays, eps=eps), slot_bytes + 2 * vec,
    )

    _, aux = block_jacobi_aux(K, free, meta)
    rows = meta.n_sb * 8
    z2 = spmv.pad_rhs(v, meta)
    r2 = spmv.pad_rhs(jnp.asarray(rng.standard_normal(n), f32), meta)
    blk = 4 * rows * 128
    record(
        "slot_sweep",
        lambda z, a: spmv.slot_sweep_b(a["op"], meta, a["aux"], z, a["r2"]),
        z2, dict(op=arrays, aux=aux, r2=r2),
        slot_bytes + 6 * blk,  # z, r, mask, msf, mpr in; z out
    )

    pk = spmv.pack_slot_bf16(arrays, meta)
    record(
        "slot_sweep_bf16",
        lambda z, a: spmv.slot_sweep_b(a["op"], meta, a["aux"], z, a["r2"]),
        z2, dict(op=pk, aux=aux, r2=r2),
        nbytes(pk["vals"], pk["cidx"], pk["srow"]) + 6 * blk,
    )

    adf, mdf = spmv.build_slot_df(K)
    vl = jnp.zeros((n,), f32)
    record(
        "slot_matvec_df",
        lambda x, a: x + a["eps"] * spmv.slot_matvec_df(
            a["op"], mdf, x, a["lo"]
        )[0],
        v, dict(op=adf, lo=vl, eps=eps),
        nbytes(adf["vals_hi"], adf["vals_lo"], adf["cidx"], adf["srow"])
        + 4 * vec,
    )

    # P1: one integration point per element, at the same refinement
    from ..models.config import TsxTunnelConfig

    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    e3 = jnp.asarray(rng.normal(0, 2e-3, (3, n_int)), f32)
    ep = jnp.asarray(rng.normal(0, 2e-4, (4, n_int)), f32)

    def rm_step(x, a):
        # the outputs ride the loop carry, so every one is written to
        # memory each step, as the solver's consumers need them
        s, ds, ind, lam, _ = dp_return_map_lanes(
            x[0] + a["eps"] * x[1][:3], a["ep"], shear, bulk, eta, c
        )
        return (x[0], s, ds, lam, ind)

    x0 = (
        e3, jnp.zeros((4, n_int), f32), jnp.zeros((3, 3, n_int), f32),
        jnp.zeros((n_int,), f32), jnp.zeros((n_int,), bool),
    )
    record(
        "dp_return_map_lanes",
        rm_step, x0, dict(ep=ep, eps=eps),
        # in: e3, ep, s[:3]; out: s (4), ds (9), lam (1), ind (1 byte)
        4 * n_int * (3 + 4 + 3) + 4 * n_int * (4 + 9 + 1) + n_int,
    )
    return dict(
        level=level, n_dofs=int(n), nnz=int(K.nnz), s_pad=int(meta.s_pad),
        n_int=int(n_int), reps=reps, ops=out,
    )


def main(level: int = 5) -> None:
    import jax

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(json.dumps(dict(
        device=dict(platform=dev.platform, kind=dev.device_kind),
        **time_operators(level),
    )))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
