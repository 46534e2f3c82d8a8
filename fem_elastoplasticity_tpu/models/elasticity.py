"""Linear elasticity on the square-with-hole domain (benchmark A).

Parity target: `Elasticity2D/pythonFEM.py:1052-1179`.  Behavioral anchors
(BASELINE.md, measured from the reference): stored energy
P1 L1 = 2786.3472189077, P1 L2 = 2717.5492666201, Q2 L1 = 2642.1861301492.

Design: geometry precompute + element stiffness + dense-free assembly +
Cholesky solve all inside one `jit`; the stored energy uses the matrix-free
operator, so the full K never exists.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.structured import Mesh, square_with_hole_mesh
from ..ops import assembly as asm
from ..ops.elements import surface_element, tables, volume_element
from .config import ElasticityConfig
from .materials import elastic_tangent_lanes, lame_moduli


class ElasticityResult(NamedTuple):
    u: jnp.ndarray  # (n_n, 2) displacements
    energy: jnp.ndarray  # stored energy 0.5 u'Ku - f'u
    mesh: Mesh


def build_mesh(cfg: ElasticityConfig) -> Mesh:
    """Mesh + boundary conditions of the elasticity benchmark.

    BCs (`Elasticity2D/pythonFEM.py:717-722`): prescribed u_x on the y=0
    edge (magnitude set by `dirichlet_scale`), u DOFs with zero coordinate
    constrained (symmetry), traction on the top face.
    """
    mesh = square_with_hole_mesh(cfg.level, cfg.etype, cfg.size_xy, cfg.size_hole)
    coords = mesh.coords
    dirichlet = np.zeros((mesh.n_nodes, 2))
    dirichlet[coords[:, 1] == 0.0, 0] = 1.0
    free = coords > 0.0  # (n_n, 2): dof constrained where its coordinate == 0
    free[coords[:, 1] == 0.0, 0] = False
    mesh.dirichlet = dirichlet
    mesh.free = free
    return mesh


def solve(cfg: ElasticityConfig = ElasticityConfig()) -> ElasticityResult:
    mesh = build_mesh(cfg)
    dtype = jnp.dtype(cfg.dtype)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)

    ref = volume_element(cfg.etype)
    surf = surface_element(cfg.etype)
    fmap, n_free = asm.free_dof_map(mesh.free)

    coords = jnp.asarray(mesh.coords, dtype)
    elems = jnp.asarray(mesh.elems)
    neumann = jnp.asarray(mesh.neumann)
    ud = jnp.asarray(cfg.dirichlet_scale * mesh.dirichlet, dtype).reshape(-1)
    free_flat = jnp.asarray(mesh.free.reshape(-1))
    free_idx = jnp.asarray(np.nonzero(mesh.free.reshape(-1))[0])

    args = dict(
        coords=coords, ud=ud, elems=elems, neumann=neumann,
        tab=tables(ref), stab=tables(surf), fmap=jnp.asarray(fmap),
        free_idx=free_idx,
        f_vol=jnp.asarray(cfg.volume_force, dtype),
        f_trac=jnp.asarray(cfg.traction_force, dtype),
    )
    n_nodes = mesh.n_nodes

    cg_tol = cfg.cg_tol if cfg.cg_tol is not None else (
        2e-7 if dtype == jnp.float32 else 1e-12
    )

    @jax.jit
    def run(a):
        geom = asm.compute_geometry(a["coords"], a["elems"], a["tab"])
        D = elastic_tangent_lanes(shear, bulk, geom.n_int, dtype)
        f_v = asm.volume_force_vector(geom, a["tab"], a["f_vol"])
        f_t = asm.traction_force_vector(
            a["coords"], a["neumann"], a["stab"], a["f_trac"], n_nodes
        )
        f_load = f_t + f_v
        # Dirichlet lift: f = f_load - K ud   (E:1147), matrix-free
        f = f_load - asm.tangent_matvec(geom, D, a["ud"])

        if cfg.solver == "dense":
            ke = asm.element_stiffness(geom, D)
            K_free = asm.assemble_dense_free(ke, geom, a["fmap"], n_free)
            cho = jax.scipy.linalg.cho_factor(K_free)
            u_free = jax.scipy.linalg.cho_solve(cho, f[a["free_idx"]])
            u = a["ud"].at[a["free_idx"]].set(u_free)
        else:
            # matrix-free block-Jacobi PCG: the full K never exists —
            # levels the reference's dense path cannot represent
            # (E:1151-1159, >10 min at level 3) solve in seconds
            from ..solve.cg import block_jacobi_preconditioner, solve_cg

            fmask = (
                jnp.zeros((2 * n_nodes,), bool).at[a["free_idx"]].set(True)
            )
            blocks = asm.node_block_diagonal(geom, D)
            pre = block_jacobi_preconditioner(blocks, fmask.reshape(-1, 2))
            du = solve_cg(
                lambda v: asm.tangent_matvec(geom, D, v),
                f, fmask, precond=pre, tol=cg_tol,
                maxiter=cfg.cg_maxiter, structure="while",
            ).x
            u = a["ud"] + du
        # stored energy 0.5 u'Ku - f_load'u  (E:1171)
        energy = 0.5 * u @ asm.tangent_matvec(geom, D, u) - f_load @ u
        return u, energy

    u, energy = run(args)
    return ElasticityResult(u=u.reshape(-1, 2), energy=energy, mesh=mesh)
