"""Matrix-free preconditioned conjugate gradients (while_loop or scan).

Replaces the reference's dense `np.linalg.solve` on the boolean-masked
stiffness (`tsx-tunnel/pythonFEM.py:1741-1748`) — the O(n^2)-memory /
O(n^3)-time scalability cliff measured in SURVEY.md §8.3 — with a
device-resident Krylov solve:

  * the operator is applied matrix-free (`ops.assembly.tangent_matvec`),
  * Dirichlet constraints are enforced by a multiplicative projector
    (mask the input and output of the operator) — `Q Q^T` never exists,
  * block-Jacobi (2x2 nodal blocks) preconditioning keeps iteration counts
    bounded for the near-incompressible footing problem (nu = 0.48).

Everything is jittable; the operator is a closure passed by the caller so
the same solver serves single-chip, `shard_map`-sharded and `vmap`-batched
problems.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class CGResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    residual: jnp.ndarray
    converged: jnp.ndarray  # bool: residual met the tolerance within maxiter
    # preconditioned-residual reduction factor |r_k|_M / |b|_M — the
    # capped-solve progress measure (solve/newton.py cg_cap_relax):
    # 1.0 = no progress, tol = converged exactly at the requested floor
    rel_residual: jnp.ndarray = jnp.nan
    # final (unscaled) residual b - A x and preconditioned residual M r —
    # already in the loop state, returned for Krylov-recycling harvests
    # (deflation_harvest); dead-code-eliminated when unused
    r: Optional[jnp.ndarray] = None
    z: Optional[jnp.ndarray] = None
    # plain 2-norm reduction |r_k|_2 / |b|_2 — the capped-solve progress
    # measure for DEFLATED solves (newton.py _cg_ok): gamma's deflated-M
    # norm is inflated for unconverged residuals whose basis-orthogonality
    # has drifted (the Q term amplifies by 1/lambda_small), which made
    # cap_relax reject capped solves that had genuinely progressed and
    # locked the footing L4 schedule one halving below the undeflated run
    rel2_residual: jnp.ndarray = jnp.nan


def block_jacobi_preconditioner(blocks: jnp.ndarray, free: jnp.ndarray):
    """Build M^{-1} from (n_n, 2, 2) nodal diagonal blocks.

    Constrained DOFs get identity rows so the inverse stays well-defined;
    the projector removes their effect anyway.

    Returns apply(r) operating on flat (2*n_n,) vectors.
    """
    free2 = free.reshape(-1, 2)
    eye = jnp.eye(2, dtype=blocks.dtype)
    # zero out coupling with constrained DOFs, put 1 on their diagonal
    mask = free2[:, :, None] & free2[:, None, :]
    b = jnp.where(mask, blocks, 0.0)
    diag_fix = (~free2).astype(blocks.dtype)
    b = b + eye * diag_fix[:, :, None] * 1.0
    # closed-form 2x2 inverse: elementwise, no batched LU
    a_, b_, c_, d_ = b[:, 0, 0], b[:, 0, 1], b[:, 1, 0], b[:, 1, 1]
    det = a_ * d_ - b_ * c_
    inv = (
        jnp.stack(
            [
                jnp.stack([d_, -b_], axis=-1),
                jnp.stack([-c_, a_], axis=-1),
            ],
            axis=-2,
        )
        / det[:, None, None]
    )

    def apply(r):
        r2 = r.reshape(-1, 2)
        return jnp.einsum("nij,nj->ni", inv, r2).reshape(-1)

    return apply


def solve_cg(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    free: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    precond: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    tol: float = 1e-12,
    atol: float = 0.0,
    maxiter: int = 1000,
    structure: str = "while",
    deflate: Optional[jnp.ndarray] = None,
) -> CGResult:
    """Projected preconditioned CG on the free-DOF subspace.

    Args:
      matvec: full-space operator v -> K v (symmetric on the free subspace).
      b:      (n_dofs,) right-hand side.
      free:   (n_n, 2) or (n_dofs,) boolean mask of unknowns.
      x0:     initial guess; its constrained part is zeroed (the returned x
              is zero on constrained DOFs — callers add Dirichlet lifts
              themselves, as the reference does via `ud`, E:1141-1147).
      tol:    relative residual tolerance (on the preconditioned norm).
      structure: "while" (dynamic trip count, stops at convergence) or
              "scan" (fixed `maxiter` trips with the state frozen after
              convergence — identical iterates, wasted trips after the
              stopping test fires).  "scan" suits bounded, small iteration
              counts (e.g. multigrid-preconditioned solves, 14-21 its
              measured): the trip count is static, so XLA can pipeline the
              body and the program needs no convergence-dependent control
              flow.

    Non-convergence is not silent: `CGResult.converged` is False when the
    iteration cap was hit before the tolerance; `solve.newton` treats that
    like Newton divergence (step halving), so a capped solve can never
    pollute a trajectory undetected.

    deflate: optional (n_dofs, k) recycled deflation basis W (orthonormal
    columns; all-zero columns = empty slots) — two-level deflated PCG in
    the finite-precision-robust A-DEF2 formulation [Tang, Nabben, Vuik,
    Erlangga, "Comparison of two-level PCG methods", J. Sci. Comput.
    2009]: standard PCG with the start iterate x0 = W E⁻¹ Wᵀ b
    (E = WᵀAW, so Wᵀ r0 = 0) and the wrapped preconditioner
    z̃ = M z-step followed by the coarse correction
    z̃ = z − W E⁻¹ ((AW)ᵀ z − Wᵀ r).  Components of the error in
    span(W) are eliminated up front and kept out by the correction, so
    a basis spanning the operator's small-eigenvalue cluster removes
    exactly the slow tail that caps the footing's near-limit tangent
    solves (ROADMAP findings).  The textbook DEF1 variant (projected
    search directions) was measured to DIVERGE in f32 — round-off
    re-excites the deflated modes and nothing corrects them; A-DEF2's
    correction term re-anneals them every iteration (the 2009 paper's
    central finding, reproduced in tests/test_cg_deflation.py).
    Setup: k operator applications (one lax.scan) + a k×k Cholesky;
    per-iteration: three (n,k) matmuls.  A non-SPD/ill-conditioned WᵀAW
    (NaN Cholesky) disables the corrections for this solve — plain PCG,
    never a polluted iterate.  x0 must be None with deflate.  NOTE: the
    relative tolerance is then measured against the DEFLATED start
    residual |r0|_M (≤ |b|_M when the basis helps) — marginally tighter
    solves, identical capped-solve semantics.
    """
    fmask = jnp.asarray(free).reshape(-1)
    proj = lambda v: jnp.where(fmask, v, 0.0)
    A = lambda v: proj(matvec(proj(v)))
    M = precond if precond is not None else (lambda r: r)

    b = proj(b)
    # scale normalization: CG is scale-invariant in exact arithmetic, but a
    # tiny right-hand side (e.g. an ~1e-13 df32-accurate Newton residual in
    # an f32 solve) drives every inner product (gamma ~ |r|^2, p^T A p)
    # into the denormal regime — stagnation, then overflow through beta
    # chains.  Solve K (x/s) = b/s with s = max|b| and rescale at the end.
    bscale = jnp.abs(b).max()
    ok_b = bscale > 0.0
    inv_s = jnp.where(ok_b, 1.0 / jnp.where(ok_b, bscale, 1.0), 0.0)
    b = b * inv_s

    # code-size note: every instantiation of A / M inlines a full copy
    # of the operator/preconditioner program (a multigrid V-cycle is a
    # large program at large meshes).  The x0=None path
    # therefore reuses r0 = b and bnorm = sqrt(gamma0), instantiating M
    # once and A zero times outside the loop.
    if deflate is not None:
        assert x0 is None, "deflate requires x0=None"
        W = jnp.where(fmask[:, None], deflate, 0.0)
        # AW via ONE scan (one A instantiation, k sequential applications)
        _, AWt = jax.lax.scan(lambda c, w: (c, A(w)), None, W.T)
        AW = AWt.T  # (n, k)
        # Gram matrix in the A-inner product; empty (zero) slots get unit
        # diagonal — their correction coefficients multiply zero columns.
        # Symmetric unit-diagonal scaling + a small jitter keep the f32
        # Cholesky well-posed across the basis' Rayleigh-quotient spread
        # (the whole point is columns with tiny wᵀAw); a NaN factor
        # (indefinite tangent) disables the corrections for this solve.
        cn = jnp.sum(W * W, axis=0)
        E = W.T @ AW
        E = 0.5 * (E + E.T) + jnp.diag(jnp.where(cn > 0.5, 0.0, 1.0))
        dE = jnp.diagonal(E)
        sE = jax.lax.rsqrt(jnp.maximum(dE, jnp.asarray(1e-30, E.dtype)))
        Es = E * sE[:, None] * sE[None, :] + 1e-5 * jnp.eye(
            E.shape[0], dtype=E.dtype
        )
        cfac = jax.scipy.linalg.cho_factor(Es)
        okd = jnp.isfinite(cfac[0]).all()
        # explicit k x k inverse, ONCE per solve: dsolve runs inside
        # every preconditioner application, and an explicit-inverse
        # matmul replaces two row-serial triangular solves there
        Ei = jax.scipy.linalg.cho_solve(
            cfac, jnp.eye(Es.shape[0], dtype=Es.dtype)
        )

        def dsolve(t):
            y = sE * (Ei @ (sE * t))
            return jnp.where(okd, y, 0.0)

        # A-DEF2: fold the coarse correction into the preconditioner —
        # the CG recurrences stay textbook PCG (docstring)
        M0 = M
        M = lambda r: (lambda z: z - W @ dsolve(AW.T @ z - W.T @ r))(M0(r))
        mu = dsolve(W.T @ b)
        x0 = W @ mu
        r0 = b - AW @ mu
        z0 = proj(M(r0))
        gamma0 = r0 @ z0
        # stopping scale: ||b|| in the UNDEFLATED preconditioner norm.
        # Both natural alternatives are wrong by orders of magnitude:
        # gamma0 (||r0||_M) silently TIGHTENS the tolerance by however
        # much of the solution the recycled basis captured (the solve
        # then over-solves and re-spends the saved iterations), while
        # b.M(b) is INFLATED by the coarse term b.Qb ~ sum (w_i.b)^2 /
        # lambda_small — the whole point of the basis is tiny Rayleigh
        # quotients — which LOOSENS the tolerance, hands Newton sloppy
        # steps and fragments the adaptive schedule (measured: footing
        # L4 went 290 -> 505 steps).  ||b||_M0 matches the undeflated
        # solver's stopping scale exactly (one extra M0 instantiation,
        # the same cost the warm-start x0 path pays).
        bnorm = jnp.sqrt(jnp.abs(b @ proj(M0(b))))
    elif x0 is None:
        x0 = jnp.zeros_like(b)
        r0 = b
        z0 = proj(M(r0))
        gamma0 = r0 @ z0
        bnorm = jnp.sqrt(jnp.abs(gamma0))
    else:
        x0 = proj(x0) * inv_s
        r0 = b - A(x0)
        z0 = proj(M(r0))
        gamma0 = r0 @ z0
        bnorm = jnp.sqrt(b @ proj(M(b)))
    limit = jnp.maximum(tol * bnorm, atol * inv_s)

    if structure == "while":

        def cond(state):
            _, r, _, _, gamma, k, stop = state
            return (~stop) & (jnp.sqrt(jnp.abs(gamma)) > limit) & (k < maxiter)

        def body(state):
            x, r, z, p, gamma, k, _ = state
            Ap = A(p)
            pAp = p @ Ap
            # breakdown guard (pAp <= 0): either f32 stagnation at the
            # dtype floor or a genuinely indefinite operator (plastic
            # apex tangents).  Keep the best iterate AND the current
            # gamma, and stop — `converged` then reports honestly whether
            # the tolerance was reached, so an indefinite tangent solve
            # surfaces as non-convergence (the Newton caller halves the
            # step, exactly like the dense path's Cholesky-NaN guard).
            ok = pAp > 0.0
            alpha = jnp.where(ok, gamma / jnp.where(ok, pAp, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = proj(M(r))
            gamma_new = jnp.where(ok, r @ z, gamma)
            beta = jnp.where(
                ok, gamma_new / jnp.where(gamma != 0.0, gamma, 1.0), 0.0
            )
            p = z + beta * p
            return (x, r, z, p, gamma_new, k + 1, ~ok)

        state = (x0, r0, z0, z0, gamma0, jnp.asarray(0), jnp.asarray(False))
        x, r, z, _, gamma, k, _ = jax.lax.while_loop(cond, body, state)
    elif structure == "scan":
        # fixed trip count; `done` freezes the state so post-convergence
        # trips are no-ops (and their 0/0 ratios never reach the state)
        def body(state, _):
            x, r, z, p, gamma, k, done = state
            Ap = A(p)
            pAp = p @ Ap
            # same breakdown guard as the while body: stop with the
            # current gamma so `converged` reports honestly
            ok = pAp > 0.0
            alpha = jnp.where(ok, gamma / jnp.where(ok, pAp, 1.0), 0.0)
            x1 = x + alpha * p
            r1 = r - alpha * Ap
            z1 = proj(M(r1))
            gamma1 = jnp.where(ok, r1 @ z1, gamma)
            beta = jnp.where(
                ok, gamma1 / jnp.where(gamma != 0.0, gamma, 1.0), 0.0
            )
            p1 = z1 + beta * p
            sel = lambda new, old: jnp.where(done, old, new)
            state = (
                sel(x1, x), sel(r1, r), sel(z1, z), sel(p1, p),
                sel(gamma1, gamma), sel(k + 1, k),
                done | (jnp.sqrt(jnp.abs(gamma1)) <= limit) | ~ok,
            )
            return state, None

        done0 = jnp.sqrt(jnp.abs(gamma0)) <= limit
        state = (x0, r0, z0, z0, gamma0, jnp.asarray(0), done0)
        (x, r, z, _, gamma, k, _), _ = jax.lax.scan(
            body, state, None, length=maxiter
        )
    else:
        raise ValueError(f"unknown structure {structure!r}")
    res = jnp.sqrt(jnp.abs(gamma))
    bn2 = jnp.sqrt(b @ b)
    res_rep = res
    if deflate is not None:
        # reported progress in the UNDEFLATED preconditioner norm: the
        # deflated gamma's M-norm is inflated for capped residuals whose
        # basis-orthogonality drifted (the Q term amplifies components by
        # 1/lambda_small), which made cap_relax (calibrated on the M0
        # norm) reject capped solves that had genuinely progressed and
        # lock the footing L4 schedule one halving below the undeflated
        # run.  One extra M0 application at exit, not per iteration.
        res_rep = jnp.sqrt(jnp.abs(r @ proj(M0(r))))
    return CGResult(
        x=x * bscale,
        iters=k,
        residual=res * bscale,
        converged=res <= limit,
        rel_residual=res_rep / jnp.where(bnorm > 0.0, bnorm, 1.0),
        r=r * bscale,
        z=z * bscale,
        rel2_residual=jnp.sqrt(r @ r) / jnp.where(bn2 > 0.0, bn2, 1.0),
    )


def deflation_harvest(W, ring, vecs, gates=None):
    """Insert candidate vectors into the recycled deflation ring basis.

    W: (n, k) orthonormal-column basis (zero columns = empty slots);
    ring: i32 scalar, next slot to overwrite (oldest-first FIFO);
    vecs: candidate vectors, e.g. a tangent solve's solution x (its
    A⁻¹b content amplifies exactly the small-eigenvalue modes) and the
    final preconditioned residual M r (what the solve could NOT
    converge — at a capped near-limit solve, the persistent cluster
    itself); gates: optional traced bool per candidate — a False gate
    skips the insert without consuming a slot (e.g. the residual of a
    CONVERGED solve is noise at the tolerance floor and would evict
    useful columns).  Each candidate is orthogonalized against the
    current basis (two-pass MGS, f32-stable); near-dependent or tiny
    candidates are discarded without consuming a slot.  Columns are
    never modified after insertion, so pairwise orthonormality holds
    by induction.

    The basis needs no A-image or eigen-structure maintenance: the
    tangent changes every Newton iteration anyway, so `solve_cg`
    recomputes AW fresh per solve (deflate doc).  Returns (W, ring).
    """
    k = W.shape[1]
    if gates is None:
        gates = [None] * len(vecs)
    for v, gate in zip(vecs, gates):
        nv0 = jnp.sqrt(v @ v)
        c = W.T @ v
        v1 = v - W @ c
        c2 = W.T @ v1
        v1 = v1 - W @ c2
        nv = jnp.sqrt(v1 @ v1)
        good = nv > 1e-3 * (nv0 + jnp.asarray(1e-30, v.dtype))
        if gate is not None:
            good = good & gate
        col = jnp.where(
            good, v1 / jnp.where(good, nv, 1.0), W[:, ring % k]
        )
        W = W.at[:, ring % k].set(col)
        ring = jnp.where(good, (ring + 1) % k, ring)
    return W, ring
