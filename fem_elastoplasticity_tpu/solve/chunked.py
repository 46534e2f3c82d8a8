"""Resume-chunked, checkpointable execution of load-stepped solvers.

This module runs any `solve/newton.py` load stepper in chunks of a few
load-loop trips per dispatch, carrying the FULL solver state (df32 pairs
included) between dispatches on device via the stepper's `resume` path —
trajectory-identical to the single-dispatch run.  With a checkpoint
path, the carry is additionally written to disk after every chunk so an
interrupted run (device/worker crash) continues from the last completed
chunk, even in a fresh process (failure recovery, SURVEY.md §5).

Model-agnostic: `models/tsx_tunnel.build_df32_chunked` and
`models/footing.build_df32_chunked` both delegate here.  The reference
has no analog — its drivers are single monolithic host loops
(`tsx-tunnel/pythonFEM.py:1763-1832`, `Plasticity2D_DP/pythonFEM.py:1010`)
with no persistence.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from ..ops.df32 import DF


def carry_of(res) -> dict:
    """LoadSteppingResult -> the stepper's resume-carry mapping."""
    c = dict(
        u=res.u, u_old=res.u_old, u_it=res.u_it, ep=res.ep,
        zeta_old=res.zeta, d_zeta=res.d_zeta,
        d_zeta_old=res.d_zeta_old, step=res.n_steps, aux=res.aux,
        zeta_hist=res.zeta_hist, monitor_hist=res.monitor_hist,
        nits_total=res.n_newton_total, ncg_total=res.n_cg_total,
    )
    if getattr(res, "defl", None) is not None:
        # recycled deflation ring (solve/newton.py cg_deflate): flat
        # keys so the checkpoint stays a plain npz mapping
        c["defl_w"], c["defl_ring"] = res.defl
    return c


def save_checkpoint(path, carry: dict) -> None:
    """Atomically persist a carry mapping (DF pairs flattened) as npz."""
    flat = {}
    for k, v in carry.items():
        if isinstance(v, DF):
            flat[k + "__hi"] = np.asarray(v.hi)
            flat[k + "__lo"] = np.asarray(v.lo)
        else:
            flat[k] = np.asarray(v)
    np.savez(str(path) + ".tmp.npz", **flat)
    os.replace(str(path) + ".tmp.npz", str(path))


def load_checkpoint(path) -> dict:
    """Inverse of `save_checkpoint` (DF pairs restored losslessly)."""
    raw = np.load(path)
    carry = {}
    for k in raw.files:
        if k.endswith("__hi"):
            carry[k[:-4]] = DF(raw[k], raw[k[:-4] + "__lo"])
        elif not k.endswith("__lo"):
            carry[k] = raw[k]
    return carry


def run_chunked(
    run: Callable,
    args,
    *,
    zeta_max: float,
    d_zeta_min: float,
    max_chunks: int = 200,
    checkpoint_path=None,
    initial_resume: Optional[dict] = None,
):
    """Drive `run(args, resume)` chunk by chunk until the schedule ends.

    `run` must be a stepper built with a small `max_trips` (the chunk
    size); the loop stops when the carried load factor reaches
    `zeta_max` or the step size underflows `d_zeta_min` (the same
    termination conditions the in-jit controller applies).  Every
    dispatch is synced before the next: the host reads the carried load
    factor to decide whether to continue, and writes the checkpoint.

    `initial_resume`: optional carry for the FIRST dispatch (e.g. a
    split-predictor start, models/tsx_tunnel.py); ignored when a
    checkpoint exists at `checkpoint_path`.
    """
    import jax

    resume = None
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        resume = load_checkpoint(checkpoint_path)
    elif initial_resume is not None:
        resume = initial_resume

    res = run(args) if resume is None else run(args, resume)
    for _ in range(max_chunks):
        jax.block_until_ready(res.u.hi if isinstance(res.u, DF) else res.u)
        carry = carry_of(res)
        if checkpoint_path is not None:
            save_checkpoint(checkpoint_path, carry)
        if isinstance(res.zeta, DF):
            z = float(res.zeta.hi) + float(res.zeta.lo)
            dz = float(res.d_zeta.hi) + float(res.d_zeta.lo)
        else:
            z = float(res.zeta)
            dz = float(res.d_zeta)
        if z >= zeta_max - 1e-12 or dz < d_zeta_min:
            break
        res = run(args, carry)
    return res
