"""Double-float (two-f32) arithmetic building blocks.

Double-float arithmetic represents a value as
an unevaluated sum `hi + lo` of two f32s (~48-bit effective mantissa,
~1e-14 relative), using error-free transformations:

  * two_sum   (Knuth)   — exact a + b = s + e with 6 f32 ops,
  * split/two_prod (Dekker) — exact a * b = p + e without FMA,
  * df_* — double-float add/sub/mul/div/sqrt built on them.

These functions are pure jnp elementwise ops, valid under jit on any
backend.  They are the substrate for the
ROADMAP double-f32 residual path: Newton residuals/criteria at ~1e-14
relative accuracy computed entirely in f32 hardware.

IMPORTANT: error-free transforms are destroyed by FMA contraction or
reassociation.  XLA does not contract a*b+c written as separate jnp ops,
and `jax_default_matmul_precision=highest` covers dots; keep these
functions free of `jnp.dot`.

MEASURED HAZARD (this repo, 2026-08): when a *long* df32 producer->consumer
chain (strain -> return map -> force, ~1000 fused elementwise ops) compiles
as one XLA fusion, the compiled result loses the compensation entirely
(residual floor 1e-13 -> 1e-6 on CPU; each stage jitted alone is exact, and
a single `optimization_barrier` at any stage boundary restores exactness).
Policy: every df32 *stage* function (`ops/assembly_df.py`,
`models/materials_df.py`) passes its DF outputs through `df_barrier`, so
composition can never re-create the mega-fusion.  Guarded by
`tests/test_df32.py` end-to-end residual-floor tests under jit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

_SPLITTER = 4097.0  # 2^12 + 1 for f32 Dekker splitting (kept for reference)
_HEAD_MASK = 0xFFFFF000  # zero the low 12 mantissa bits -> 12-bit head


class DF(NamedTuple):
    """Double-float number: value = hi + lo, |lo| <= ulp(hi)/2."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def df(x) -> DF:
    """Lift an f32 array (or f64 array, split exactly) to double-float."""
    x = jnp.asarray(x)
    if x.dtype == jnp.float64:
        hi = x.astype(jnp.float32)
        lo = (x - hi.astype(jnp.float64)).astype(jnp.float32)
        return DF(hi, lo)
    return DF(x.astype(jnp.float32), jnp.zeros_like(x, jnp.float32))


def _opaque(hi, lo) -> DF:
    """DF constant made opaque to XLA.

    XLA's algebraic simplifier reassociates float expressions WHEN CONSTANT
    OPERANDS ARE INVOLVED (e.g. `(a + c) - a -> c`) — precisely the rewrite
    that deletes a `two_sum` compensation term.  Measured in this repo: any
    df32 chain touching a literal (material constants, closure-captured
    scalars) silently loses its compensation inside large fusions, while
    all-variable chains stay exact.  Hiding the literal behind an
    `optimization_barrier` removes the 'constant operand' precondition, so
    the simplifier leaves the EFT alone.  Costs nothing (scalar barrier,
    once per program).
    """
    hi, lo = jax.lax.optimization_barrier((jnp.asarray(hi), jnp.asarray(lo)))
    return DF(hi, lo)


def to_f64(a: DF) -> jnp.ndarray:
    return a.hi.astype(jnp.float64) + a.lo.astype(jnp.float64)


def df_barrier(a: DF) -> DF:
    """Make a DF value opaque to XLA fusion/simplification.

    See the module-docstring hazard note: stage outputs must be barriered
    or a fused mega-chain silently drops the compensation terms.

    CAVEAT (measured): XLA:CPU strips optimization barriers during its
    pipeline (12 before optimization -> 0 after), so on that backend this
    does NOT reliably protect EFTs — `df_pin` with a runtime-zeros
    argument is the load-bearing guard; this barrier remains as free
    insurance for backends that honor it.
    """
    hi, lo = jax.lax.optimization_barrier((a.hi, a.lo))
    return DF(hi, lo)


def df_pin(a: DF, z: Optional[jnp.ndarray]) -> DF:
    """Pin a DF value with a *runtime* zeros array (a real jit argument).

    Adding an argument whose values the compiler cannot know blocks every
    algebraic rewrite involving the pinned value — the only guard measured
    to survive the XLA:CPU pipeline (optimization barriers are stripped,
    `0.0 * runtime_array` is folded, bitcast round-trips are canonicalized
    away).  `z` MUST be a traced argument that is all zeros at runtime and
    at least `a.hi.size` long; pass None to skip (no-op).
    """
    if z is None:
        return a
    if a.hi.ndim == 0:
        zz = z[0]
    else:
        zz = z[: a.hi.size].reshape(a.hi.shape)
    return DF(a.hi + zz, a.lo + zz)


def two_sum(a, b):
    """Exact a + b = (s, e) (Knuth; no magnitude assumption)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a, b):
    """Exact a + b = (s, e), REQUIRES |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Exact split a = x + y with 12-bit halves (f32) via mantissa masking.

    Dekker's multiplicative split (`c = 4097*a; x = c - (c - a)`) is
    destroyed by LLVM fp-contraction when XLA:CPU vectorizes a large fused
    loop: `c - a` contracts to `fma(4097, a, -a)`, skipping the rounding
    the split depends on (measured in this repo: f32-level error appears
    in wide df32 fusions, single-lane and eager stay exact, and
    `--xla_cpu_enable_fast_math=false` does NOT prevent it).  Masking the
    low 12 mantissa bits is a pure integer operation no FP rewrite can
    touch: x = top 12 bits of the mantissa (plus sign/exponent), y = a - x
    is exact with <= 12 significant bits, so all Dekker partial products
    in `two_prod` stay exact.
    """
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    x = jax.lax.bitcast_convert_type(
        bits & jnp.uint32(_HEAD_MASK), jnp.float32
    )
    y = a - x
    return x, y


def two_prod(a, b):
    """Exact a * b = (p, e) via Dekker splitting (no FMA dependency)."""
    p = a * b
    a1, a2 = split(a)
    b1, b2 = split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def cross_sum(a, b, c, d):
    """a*b + c*d for the low-order cross terms of a double-float product.

    Each product goes through `two_prod`, so it has more than one use and
    no single-use product feeds an add.  A compiler may contract such a
    pair into a fused multiply-add depending on which consumers share the
    fused kernel (XLA:CPU via LLVM does), so a plain `a*b + c*d` can round
    differently in two programs that evaluate the same expression — the
    single-device and the row-sharded solves.  Here every rounding is
    fixed by the expression alone (the two_prod partial products are
    exact, so contracting them changes nothing).
    """
    p1, e1 = two_prod(a, b)
    p2, e2 = two_prod(c, d)
    return (p1 + p2) + (e1 + e2)


def df_add(a: DF, b: DF) -> DF:
    s, e = two_sum(a.hi, b.hi)
    e = e + a.lo + b.lo
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def df_sub(a: DF, b: DF) -> DF:
    return df_add(a, df_neg(b))


def df_mul(a: DF, b: DF) -> DF:
    p, e = two_prod(a.hi, b.hi)
    e = e + cross_sum(a.hi, b.lo, a.lo, b.hi)
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_const(c: float, like=None) -> DF:
    """Lift a Python/f64 scalar to a double-float constant (exact split)."""
    import numpy as np

    hi = np.float32(c)
    lo = np.float32(float(c) - float(hi))
    if like is None:
        return _opaque(hi, lo)
    z = 0 * like
    return _opaque(z + jnp.float32(hi), z + jnp.float32(lo))


def df_scale(a: DF, c: float) -> DF:
    """Multiply by a scalar (the scalar itself carried in double-float)."""
    return df_mul(a, df_const(c, like=a.hi))


def df_div(a: DF, b: DF) -> DF:
    """Division via one Newton correction of the f32 quotient."""
    q1 = a.hi / b.hi
    # r = a - q1*b (double-float)
    p, e = two_prod(q1, b.hi)
    r_hi, r_e = two_sum(a.hi, -p)
    p1, e1 = two_prod(q1, b.lo)  # contraction-proof, see cross_sum
    r = r_hi + (r_e + a.lo - e - (p1 + e1))
    q2 = r / b.hi
    hi, lo = fast_two_sum(q1, q2)
    return DF(hi, lo)


def df_sqrt(a: DF) -> DF:
    """Square root via one Newton correction of the f32 root."""
    s1 = jnp.sqrt(a.hi)
    # r = a - s1^2
    p, e = two_prod(s1, s1)
    r_hi, r_e = two_sum(a.hi, -p)
    r = r_hi + (r_e + a.lo - e)
    safe = jnp.where(s1 > 0, s1, 1.0)
    s2 = jnp.where(s1 > 0, r / (2.0 * safe), 0.0)
    hi, lo = fast_two_sum(s1, s2)
    return DF(hi, lo)


def materialize(tree):
    """Compute every array leaf of `tree` once, in a kernel of its own.

    An identity scatter, which XLA fuses into no consumer: without it a
    long elementwise producer (the return map) is fused into each of its
    consumers — recomputed per gathered element inside the force
    operator's gather — and on XLA:CPU the copies may contract products
    differently (`cross_sum`), so two programs stop agreeing bitwise.
    """

    def one(x):
        flat = x.reshape(-1)
        idx = jnp.arange(flat.size)
        return (
            jnp.zeros_like(flat)
            .at[idx]
            .set(flat, unique_indices=True, indices_are_sorted=True)
            .reshape(x.shape)
        )

    return jax.tree.map(one, tree)


def df_allreduce(a: DF, axis_name: str) -> DF:
    """Exact all-reduce of compensated per-shard partials (shard_map).

    A plain `psum` of the hi and lo members separately would drop the
    carries of the hi additions (~eps32 * |sum| — fatal to the ~1e-14
    df32 floor).  Instead the (hi, lo) pairs are all-gathered over the
    mesh axis (one collective each) and folded with the compensated
    `df_add` over the static shard axis, so the reduction is itself a
    double-float computation.  Every shard computes the identical fold —
    the result is replicated, like `psum`.
    """
    import jax

    gh = jax.lax.all_gather(a.hi, axis_name)  # (n_shards, ...)
    gl = jax.lax.all_gather(a.lo, axis_name)
    acc = DF(gh[0], gl[0])
    for k in range(1, gh.shape[0]):
        acc = df_add(acc, DF(gh[k], gl[k]))
    return df_barrier(acc)
