"""Double-float (two-f32) Drucker-Prager return map — fast-path residual.

Same math as `models.materials.dp_return_map_lanes` (reference:
`tsx-tunnel/pythonFEM.py:990-1157`, SURVEY.md §2.3, with the two defects
fixed there), evaluated in double-float arithmetic (`ops/df32.py`) so the
fast path's Newton *residual* reaches ~1e-14 relative accuracy on pure f32
hardware.  The consistent tangent `ds` is returned in plain f32 from the
double-float heads — it only feeds the (inexact-Newton) linear solves,
where f32 accuracy costs convergence nothing.

Branch predicates (yield, apex) are evaluated on the double-float heads;
DF normalization (|lo| <= ulp(hi)/2) makes sign(hi) == sign(hi + lo), so
the branch decisions match a true f64 evaluation except at ties below the
~1e-14 noise floor — where the return map is continuous, so the stress is
branch-insensitive anyway.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..ops.df32 import (
    DF,
    df_add,
    df_barrier,
    df_const,
    df_div,
    df_mul,
    df_sqrt,
    df_sub,
)

SQRT2 = float(np.sqrt(2.0))


def _sel(cond, a: DF, b: DF) -> DF:
    return DF(jnp.where(cond, a.hi, b.hi), jnp.where(cond, a.lo, b.lo))


def _comp(x: DF, i) -> DF:
    return DF(x.hi[i], x.lo[i])


def _stack(parts) -> DF:
    return DF(
        jnp.stack([p.hi for p in parts], axis=0),
        jnp.stack([p.lo for p in parts], axis=0),
    )


class _Consts(NamedTuple):
    """Derived material constants, each an exact f64 -> df32 split."""

    two_g: DF
    bulk: DF
    eta: DF
    c: DF
    denom_s: DF
    inv_denom_s: DF
    inv_denom_a: DF
    crit2_k: DF  # denom_a / (shear * sqrt(2))
    sqrt2_g: DF  # sqrt(2) * shear
    bulk_eta: DF
    apex: DF  # c / eta
    apex_shift: DF  # c / (3 K eta)
    eta_third: DF
    inv_sqrt2: DF
    third: DF


def _consts(shear: float, bulk: float, eta: float, c: float, like) -> _Consts:
    denom_a = bulk * eta * eta
    d = lambda v: df_const(float(v), like=like)
    return _Consts(
        two_g=d(2.0 * shear),
        bulk=d(bulk),
        eta=d(eta),
        c=d(c),
        denom_s=d(shear + denom_a),
        inv_denom_s=d(1.0 / (shear + denom_a)),
        inv_denom_a=d(1.0 / denom_a),
        crit2_k=d(denom_a / (shear * SQRT2)),
        sqrt2_g=d(SQRT2 * shear),
        bulk_eta=d(bulk * eta),
        apex=d(c / eta),
        apex_shift=d(c / (3.0 * bulk * eta)),
        eta_third=d(eta / 3.0),
        inv_sqrt2=d(1.0 / SQRT2),
        third=d(1.0 / 3.0),
    )


def consts_host(shear, bulk, eta, c) -> _Consts:
    """Host-side f64 material constants as DF arrays (jit arguments).

    `eta`/`c` may be numpy arrays (material ensembles): every leaf is
    broadcast to their common shape so the whole _Consts pytree can be
    `vmap`-ed over a leading member axis uniformly.  Passing constants as
    runtime arguments also sidesteps both df32 hazards (literals invite
    reassociation; embedded array constants bloat the program —
    utils/jitsafe.py).
    """
    import numpy as np

    eta = np.asarray(eta, np.float64)
    c = np.asarray(c, np.float64)
    shape = np.broadcast(eta, c).shape
    denom_a = bulk * eta * eta

    def d(v):
        v = np.broadcast_to(np.asarray(v, np.float64), shape)
        hi = v.astype(np.float32)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
        return DF(jnp.asarray(hi), jnp.asarray(lo))

    return _Consts(
        two_g=d(2.0 * shear + 0.0 * eta),
        bulk=d(bulk + 0.0 * eta),
        eta=d(eta),
        c=d(c),
        denom_s=d(shear + denom_a),
        inv_denom_s=d(1.0 / (shear + denom_a)),
        inv_denom_a=d(1.0 / denom_a),
        crit2_k=d(denom_a / (shear * SQRT2)),
        sqrt2_g=d(SQRT2 * shear + 0.0 * eta),
        bulk_eta=d(bulk * eta),
        apex=d(c / eta),
        apex_shift=d(c / (3.0 * bulk * eta)),
        eta_third=d(eta / 3.0),
        inv_sqrt2=d(1.0 / SQRT2 + 0.0 * eta),
        third=d(1.0 / 3.0 + 0.0 * eta),
    )


def dp_return_map_lanes_df(
    e3: DF,
    ep_prev: DF,
    shear: float,
    bulk: float,
    eta: float,
    c: float,
    e0: Optional[DF] = None,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
    consts: Optional[_Consts] = None,
):
    """Lane-major DP return map in double-float.

    Args mirror `dp_return_map_lanes`: e3 DF(3, n), ep_prev DF(4, n),
    e0 optional DF(4,) or DF(4, n).  Returns
    (s DF(4, n), ds f32 (3, 3, n), ind_p (n,), lam_hi (n,), ep DF(4, n)).
    `consts` overrides the literal-derived constants with traced DF
    scalars (`consts_host` — material ensembles under vmap).
    """
    n = e3.hi.shape[1]
    like = e3.hi[0]
    k = consts if consts is not None else _consts(shear, bulk, eta, c, like)
    zero = jnp.zeros((n,), jnp.float32)
    zdf = DF(zero, zero)

    e4 = [_comp(e3, 0), _comp(e3, 1), _comp(e3, 2), zdf]
    if e0 is not None:
        for i in range(4):
            e0i = DF(e0.hi[i], e0.lo[i])
            e4[i] = df_add(e4[i], e0i)

    et = [df_sub(e4[i], _comp(ep_prev, i)) for i in range(4)]
    tr = df_add(df_add(et[0], et[1]), et[3])
    tr3 = df_mul(tr, k.third)
    dev = [
        df_sub(et[0], tr3),
        df_sub(et[1], tr3),
        DF(et[2].hi * 0.5, et[2].lo * 0.5),
        df_sub(et[3], tr3),
    ]

    ktr = df_mul(k.bulk, tr)
    s_tr = [
        df_add(df_mul(k.two_g, dev[0]), ktr),
        df_add(df_mul(k.two_g, dev[1]), ktr),
        df_mul(k.two_g, dev[2]),
        df_add(df_mul(k.two_g, dev[3]), ktr),
    ]

    nsq = df_add(
        df_add(df_mul(et[0], dev[0]), df_mul(et[1], dev[1])),
        df_add(df_mul(et[2], dev[2]), df_mul(et[3], dev[3])),
    )
    nsq = _sel(nsq.hi > 0.0, nsq, zdf)  # clamp (T:1065-1068)
    norm_e = df_sqrt(nsq)
    rho_tr = df_mul(k.two_g, norm_e)
    p_tr = ktr

    eta_p = df_mul(k.eta, p_tr)
    crit1 = df_sub(
        df_add(df_mul(rho_tr, k.inv_sqrt2), eta_p), k.c
    )
    crit2 = df_sub(df_sub(eta_p, df_mul(k.crit2_k, rho_tr)), k.c)

    ind_p = crit1.hi > 0.0
    ind_s = ind_p & (crit2.hi <= 0.0)
    ind_a = ind_p & (crit2.hi > 0.0)

    lam_s = df_mul(crit1, k.inv_denom_s)
    lam_a = df_mul(df_sub(eta_p, k.c), k.inv_denom_a)
    lam = _sel(ind_s, lam_s, _sel(ind_a, lam_a, zdf))

    pos = norm_e.hi > 0.0
    safe = _sel(pos, norm_e, DF(jnp.ones_like(zero), zero))
    n_hat = [_sel(pos, df_div(dev[i], safe), zdf) for i in range(4)]

    m = [
        df_add(df_mul(k.sqrt2_g, n_hat[0]), k.bulk_eta),
        df_add(df_mul(k.sqrt2_g, n_hat[1]), k.bulk_eta),
        df_mul(k.sqrt2_g, n_hat[2]),
        df_add(df_mul(k.sqrt2_g, n_hat[3]), k.bulk_eta),
    ]

    apex = [k.apex, k.apex, zdf, k.apex]
    s_parts = []
    for i in range(4):
        smooth = df_sub(s_tr[i], df_mul(lam_s, m[i]))
        a_i = DF(jnp.broadcast_to(apex[i].hi, (n,)), jnp.broadcast_to(apex[i].lo, (n,)))
        s_parts.append(_sel(ind_s, smooth, _sel(ind_a, a_i, s_tr[i])))
    s = _stack(s_parts)

    # consistent tangent in plain f32 from the double-float heads
    shear32, bulk32 = np.float32(shear), np.float32(bulk)
    n0, n1, n2 = n_hat[0].hi, n_hat[1].hi, n_hat[2].hi
    m0, m1, m2 = m[0].hi, m[1].hi, m[2].hi
    safe_rho = jnp.where(rho_tr.hi > 0.0, rho_tr.hi, 1.0)
    ca = jnp.where(
        ind_s,
        np.float32(2.0 * SQRT2 * shear * shear) * lam_s.hi / safe_rho,
        0.0,
    )
    # 1/(G + K eta^2) from the consts (k.eta may be a traced ensemble
    # member; the literal `eta` is unused when consts is supplied)
    ms = jnp.where(ind_s, k.inv_denom_s.hi, np.float32(0.0))
    e_diag = np.float32(4.0 * shear / 3.0 + bulk)
    e_off = np.float32(-2.0 * shear / 3.0 + bulk)
    d00 = e_diag - ca * (np.float32(2.0 / 3.0) - n0 * n0) - m0 * m0 * ms
    d11 = e_diag - ca * (np.float32(2.0 / 3.0) - n1 * n1) - m1 * m1 * ms
    d22 = shear32 - ca * (np.float32(0.5) - n2 * n2) - m2 * m2 * ms
    d01 = e_off - ca * (np.float32(-1.0 / 3.0) - n0 * n1) - m0 * m1 * ms
    d02 = ca * n0 * n2 - m0 * m2 * ms
    d12 = ca * n1 * n2 - m1 * m2 * ms
    not_a = jnp.where(ind_a, np.float32(0.0), np.float32(1.0))
    d00, d11, d22 = d00 * not_a, d11 * not_a, d22 * not_a
    d01, d02, d12 = d01 * not_a, d02 * not_a, d12 * not_a
    ds = jnp.stack(
        [
            jnp.stack([d00, d01, d02], axis=0),
            jnp.stack([d01, d11, d12], axis=0),
            jnp.stack([d02, d12, d22], axis=0),
        ],
        axis=0,
    )

    if apply_plastic_strain:
        flow = [
            df_add(df_mul(n_hat[0], k.inv_sqrt2), k.eta_third),
            df_add(df_mul(n_hat[1], k.inv_sqrt2), k.eta_third),
            df_mul(df_mul(n_hat[2], k.inv_sqrt2), df_const(2.0, like=like)),
            df_add(df_mul(n_hat[3], k.inv_sqrt2), k.eta_third),
        ]
        base = et if apex_ep_uses_trial else e4
        ep_parts = []
        for i in range(4):
            sm = df_add(_comp(ep_prev, i), df_mul(lam_s, flow[i]))
            ax = base[i] if i == 2 else df_sub(base[i], k.apex_shift)
            ep_parts.append(
                _sel(ind_s, sm, _sel(ind_a, ax, _comp(ep_prev, i)))
            )
        ep = df_barrier(_stack(ep_parts))
    else:
        ep = ep_prev

    return df_barrier(s), ds, ind_p, lam.hi, ep
