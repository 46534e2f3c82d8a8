"""Multi-chip SPMD: element partitioning over a device mesh via `shard_map`.

The reference is single-process (SURVEY.md §2.4 — no MPI/NCCL/threads).
The scaling design: shard *integration points / elements* across
devices, replicate the nodal DOF vectors.  Assembly is element-local, so
the only collectives are `psum`s of scattered nodal partials (internal
force, preconditioner blocks).  The adaptive Newton control
flow is replicated — every device runs the identical `lax.while_loop`
schedule, so no host involvement and no divergence.

Geometry is lane-major (see `ops.assembly`); the shard axis is the minor
integration-point axis of B/weight and the element axis of the DOF maps.
Padding slots (zero B, zero weight) are inert in every reduction.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import assembly as asm
from ..ops.elements import ReferenceElement

ELEM_AXIS = "elems"


def make_device_mesh(
    n_devices: Optional[int] = None, axis: str = ELEM_AXIS
) -> Mesh:
    """1-D mesh over the first `n_devices` devices (all by default).

    Every sharded path builds its mesh here: element sharding, operator
    row sharding (`ops.spmv.OP_AXIS`) and ensemble member sharding.  The
    mesh follows the algorithm alone — the devices are taken in order,
    with no interconnect topology assumed.
    """
    devs = jax.devices()
    n = len(devs) if n_devices is None else int(n_devices)
    if n > len(devs):
        raise ValueError(f"{n} devices requested, {len(devs)} available")
    return Mesh(np.array(devs[:n]), (axis,))


def sharded_geometry(
    coords: jnp.ndarray,
    elems: np.ndarray,
    ref: ReferenceElement,
    mesh: Mesh,
) -> asm.Geometry:
    """Compute geometry padded/sharded over the device mesh.

    Element count is padded so each shard holds an equal, lane-aligned
    block of whole elements; the padding is inert (zero B and weight).
    """
    n_shards = mesh.devices.size
    n_e = elems.shape[0]
    n_q = ref.n_q
    per_shard = -(-n_e // n_shards)
    while (per_shard * n_q) % asm.LANE_PAD != 0:
        per_shard += 1
    geom = asm.compute_geometry(coords, elems, ref, pad_to=per_shard * n_shards * n_q)

    spec = lambda *p: NamedSharding(mesh, P(*p))
    return asm.Geometry(
        B=jax.device_put(geom.B, spec(None, None, ELEM_AXIS)),
        weight=jax.device_put(geom.weight, spec(ELEM_AXIS)),
        edofs=jax.device_put(geom.edofs, spec(ELEM_AXIS, None)),
        edofs_t=jax.device_put(geom.edofs_t, spec(None, ELEM_AXIS)),
        n_nodes=geom.n_nodes,
        n_q=geom.n_q,
        n_real=geom.n_real,
    )


def sharded_stepper(mesh: Mesh, geom: asm.Geometry, build_fn,
                    cg_deflate: int = 0):
    """Wrap a load-stepper builder in shard_map over the element axis.

    Args:
      geom: the sharded Geometry (static dims only are read here).
      build_fn: (local_geom, axis_name, *extra) -> run(U_it0, aux0,
                d_zeta0); typically a closure over
                `solve.newton.build_load_stepper` with solver="cg".
      cg_deflate: MUST match the build_fn's stepper setting — a
                deflation-enabled stepper returns a `defl=(W, ring)`
                ring-state entry, and out_specs has to carry a
                matching (replicated) spec or shard_map fails with a
                pytree structure mismatch at trace time.

    Returns run(garr, U_it0, aux0, d_zeta0, *extra): `garr` is the
    geometry-array dict (`geometry_args`) and the `extra` arrays are
    free-DOF indices, e0 directions, etc. — EVERY array must be passed
    here rather than closed over (`utils/jitsafe.py`).
    Plastic-strain state stays sharded across devices for the whole
    solve.
    """
    e3 = P(None, None, ELEM_AXIS)
    e1 = P(ELEM_AXIS)
    e_r = P(ELEM_AXIS, None)
    e_c = P(None, ELEM_AXIS)
    r = P()

    def inner(B, weight, edofs, edofs_t, U_it0, aux0, d_zeta0, *extra):
        local = asm.Geometry(
            B=B, weight=weight, edofs=edofs, edofs_t=edofs_t,
            n_nodes=geom.n_nodes, n_q=geom.n_q, n_real=geom.n_real,
        )
        run = build_fn(local, ELEM_AXIS, *extra)
        return run(U_it0, aux0, d_zeta0)

    from ..solve.newton import LoadSteppingResult

    out_specs = LoadSteppingResult(
        u=r, ep=e_c, zeta_hist=r, monitor_hist=r, n_steps=r,
        n_newton_total=r, zeta=r, d_zeta=r, n_plastic=r, n_cg_total=r,
        u_old=r, u_it=r, d_zeta_old=r, aux=r,
        defl=((r, r) if cg_deflate else None),
    )

    def run(garr, U_it0, aux0, d_zeta0, *extra):
        mapped = shard_map(
            inner,
            mesh=mesh,
            in_specs=(e3, e1, e_r, e_c, r, r, r) + (r,) * len(extra),
            out_specs=out_specs,
            check_vma=False,
        )
        return mapped(
            garr["B"], garr["weight"], garr["edofs"], garr["edofs_t"],
            U_it0, aux0, d_zeta0, *extra,
        )

    return run


def geometry_args(geom: asm.Geometry) -> dict:
    """Geometry arrays as a jit-argument dict: sharded geometry crosses jit
    boundaries as arguments, never as closure constants
    (`sharded_stepper` run signature)."""
    return dict(
        B=geom.B, weight=geom.weight, edofs=geom.edofs,
        edofs_t=geom.edofs_t,
    )


def geometry_args_df(gdf) -> dict:
    """Double-float geometry arrays as a jit-argument dict
    (`sharded_stepper_df` run signature)."""
    out = geometry_args(gdf.hi)
    out.update(B_lo=gdf.B_lo, w_lo=gdf.w_lo, gmap=gdf.gmap)
    return out


def sharded_geometry_df(coords, elems, ref: ReferenceElement, mesh: Mesh):
    """Double-float geometry padded/sharded over the device mesh.

    Like `sharded_geometry` but for the df32 fast path: B/weight hi+lo
    pairs are element-sharded, and the per-DOF force gather map is built
    PER SHARD (positions index each shard's local force-slot array) and
    stacked along a sharded leading axis.  Returns (GeometryDF, per_shard
    element count).
    """
    from ..ops import assembly_df as adf

    n_shards = mesh.devices.size
    n_e = np.asarray(elems).shape[0]
    n_q = ref.n_q
    per_shard = -(-n_e // n_shards)
    while (per_shard * n_q) % asm.LANE_PAD != 0:
        per_shard += 1
    pad_to = per_shard * n_shards * n_q
    gdf = adf.geometry_df(coords, elems, ref, pad_to=pad_to)

    edofs_t = np.asarray(gdf.hi.edofs_t)
    n_dofs = 2 * gdf.hi.n_nodes
    np2 = edofs_t.shape[0]
    locs = []
    for s in range(n_shards):
        lo, hi_ = s * per_shard, (s + 1) * per_shard
        n_real_local = max(0, min(n_e, hi_) - lo)
        locs.append(
            adf.dof_gather_map(edofs_t[:, lo:hi_], n_real_local, n_dofs)
        )
    k_max = max(g.shape[1] for g in locs)
    # pad columns with each shard's zero slot (np2 * per_shard)
    gmap3 = np.full((n_shards, n_dofs, k_max), np2 * per_shard, np.int32)
    for s, g in enumerate(locs):
        gmap3[s, :, : g.shape[1]] = g

    spec = lambda *p: NamedSharding(mesh, P(*p))
    hi = gdf.hi
    hi_sharded = asm.Geometry(
        B=jax.device_put(hi.B, spec(None, None, ELEM_AXIS)),
        weight=jax.device_put(hi.weight, spec(ELEM_AXIS)),
        edofs=jax.device_put(hi.edofs, spec(ELEM_AXIS, None)),
        edofs_t=jax.device_put(hi.edofs_t, spec(None, ELEM_AXIS)),
        n_nodes=hi.n_nodes,
        n_q=hi.n_q,
        n_real=hi.n_real,
    )
    gdf_sharded = adf.GeometryDF(
        hi=hi_sharded,
        B_lo=jax.device_put(gdf.B_lo, spec(None, None, ELEM_AXIS)),
        w_lo=jax.device_put(gdf.w_lo, spec(ELEM_AXIS)),
        gmap=jax.device_put(jnp.asarray(gmap3), spec(ELEM_AXIS, None, None)),
    )
    return gdf_sharded, per_shard


def sharded_stepper_df(mesh: Mesh, gdf, build_fn, cg_deflate: int = 0):
    """shard_map wrapper for the df32 load stepper.

    build_fn: (local_gdf, axis_name, *extra) -> run(U_it0_df, aux0,
    d_zeta0_df).  DF state (u, ep, zeta, monitor) is carried as pairs:
    nodal/scalar pairs replicated, integration-point pairs element-
    sharded.  Nodal force reductions inside the stepper use the exact
    compensated all-reduce (`ops.df32.df_allreduce`).
    cg_deflate must match the stepper's setting (`sharded_stepper` doc).

    Returns run(garr, U_it0, aux0, d_zeta0, *extra): `garr` is the df
    geometry-array dict (`geometry_args_df`) — passed at call time, not
    closed over (`sharded_stepper` doc).
    """
    from ..ops import assembly_df as adf
    from ..ops.df32 import DF
    from ..solve.newton import LoadSteppingResult

    e3 = P(None, None, ELEM_AXIS)
    e1 = P(ELEM_AXIS)
    e_r = P(ELEM_AXIS, None)
    e_c = P(None, ELEM_AXIS)
    g3 = P(ELEM_AXIS, None, None)
    r = P()

    def inner(B, w, edofs, edofs_t, B_lo, w_lo, gmap3, U_it0, aux0,
              d_zeta0, *extra):
        local = adf.GeometryDF(
            hi=asm.Geometry(
                B=B, weight=w, edofs=edofs, edofs_t=edofs_t,
                n_nodes=gdf.hi.n_nodes, n_q=gdf.hi.n_q,
                n_real=gdf.hi.n_real,
            ),
            B_lo=B_lo, w_lo=w_lo, gmap=gmap3[0],
        )
        run = build_fn(local, ELEM_AXIS, *extra)
        return run(U_it0, aux0, d_zeta0)

    rdf = DF(r, r)
    edf = DF(e_c, e_c)
    out_specs = LoadSteppingResult(
        u=rdf, ep=edf, zeta_hist=r, monitor_hist=rdf, n_steps=r,
        n_newton_total=r, zeta=rdf, d_zeta=rdf, n_plastic=r, n_cg_total=r,
        u_old=rdf, u_it=rdf, d_zeta_old=rdf, aux=r,
        defl=((r, r) if cg_deflate else None),
    )

    def run(garr, U_it0, aux0, d_zeta0, *extra):
        mapped = shard_map(
            inner,
            mesh=mesh,
            in_specs=(e3, e1, e_r, e_c, e3, e1, g3, rdf, r, rdf)
            + (r,) * len(extra),
            out_specs=out_specs,
            check_vma=False,
        )
        return mapped(
            garr["B"], garr["weight"], garr["edofs"], garr["edofs_t"],
            garr["B_lo"], garr["w_lo"], garr["gmap"],
            U_it0, aux0, d_zeta0, *extra,
        )

    return run
