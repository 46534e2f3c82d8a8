"""Guard against embedded array constants in jitted programs.

A jitted program that closes over a large array embeds it as a constant:
the compiled program and its compile-cache entry grow with the mesh, and
a program that differs only in the data compiles anew instead of hitting
the cache.  The package-wide idiom is therefore: every array crosses the
jit boundary as an ARGUMENT.  This module machine-checks that idiom
by scanning a lowered program's StableHLO text for large `constant` ops.

Small constants are unavoidable and harmless (quadrature tables the
compiler folds, 2x2 identities, `iota`-free literal vectors) — the
threshold flags only arrays past `max_elems` (default 256: everything
below that size in this package is a deliberate scalar-table literal,
and the real geometry/operator arrays are thousands of elements at
minimum).
"""
from __future__ import annotations

import re
from typing import List, Tuple

# `stablehlo.constant dense<...> : tensor<3x3xf32>` (also mhlo.constant)
_CONST_RE = re.compile(
    r"(?:stablehlo|mhlo)\.constant\b.*?:\s*tensor<([^>]*)>"
)


def _elems(shape_str: str) -> int:
    n = 1
    for tok in shape_str.split("x")[:-1]:  # last token is the dtype
        if tok.isdigit():
            n *= int(tok)
    return n


def embedded_constants(
    hlo_text: str, max_elems: int = 256
) -> List[Tuple[int, str]]:
    """(element_count, tensor_type) of every constant above the threshold."""
    out = []
    for m in _CONST_RE.finditer(hlo_text):
        n = _elems(m.group(1))
        if n > max_elems:
            out.append((n, m.group(1)))
    return out


def assert_no_embedded_constants(jitted, args: tuple, max_elems: int = 256):
    """Lower `jitted(*args)` and assert no large embedded constants.

    `jitted` must be a `jax.jit`-wrapped callable.  Raises AssertionError
    naming the offending tensor types (largest first) — each one is an
    array that should have been passed through the jit boundary as an
    argument (module docstring).
    """
    text = jitted.lower(*args).as_text()
    bad = sorted(embedded_constants(text, max_elems), reverse=True)
    assert not bad, (
        f"jitted program embeds {len(bad)} array constant(s) > "
        f"{max_elems} elems (pass them as jit arguments): "
        f"{[t for _, t in bad[:8]]}"
    )
