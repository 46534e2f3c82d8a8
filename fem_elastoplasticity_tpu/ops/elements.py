"""Reference-element tables: quadrature rules and Lagrange basis functions.

Design note: these tables are tiny compile-time constants (numpy
float64).  They are baked into jitted kernels as literals, so nothing here
touches JAX at runtime.

Parity: reproduces the rules/basis of the reference implementation
(`/root/reference/tsx-tunnel/pythonFEM.py:67-308`): P1/P2/Q1/Q2/P4 volume
rules, P1/P2/Q1/Q2 surface rules.  The reference left the P4 surface rule
unimplemented (SURVEY.md §2.3 defect 5); we complete it here with a 5-node
quartic edge element and 5-point Gauss rule.

Basis derivatives are computed with exact forward-mode dual numbers rather
than hand-transcribed formulas, so they equal the analytic derivatives to
machine precision (the reference's explicit derivative tables agree with
these values).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np


class ElementType(enum.Enum):
    """Lagrange finite element families supported by the framework.

    Mirrors `LagrangeElementType` in the reference
    (`tsx-tunnel/pythonFEM.py:57-64`).
    """

    P1 = 1  # linear triangle, 3 nodes
    P2 = 2  # quadratic triangle, 6 nodes
    Q1 = 3  # bilinear quad, 4 nodes
    Q2 = 4  # 8-node serendipity quad
    P4 = 5  # quartic triangle, 15 nodes

    @property
    def is_triangle(self) -> bool:
        return self in (ElementType.P1, ElementType.P2, ElementType.P4)

    @property
    def is_quad(self) -> bool:
        return self in (ElementType.Q1, ElementType.Q2)

    @property
    def n_vertices(self) -> int:
        return 3 if self.is_triangle else 4


# ---------------------------------------------------------------------------
# Exact forward-mode differentiation for polynomial basis functions.
# ---------------------------------------------------------------------------
class _Dual:
    """Value plus two partial derivatives; exact for polynomial expressions."""

    __slots__ = ("v", "d1", "d2")

    def __init__(self, v, d1=0.0, d2=0.0):
        self.v = np.asarray(v, dtype=np.float64)
        self.d1 = np.asarray(d1, dtype=np.float64)
        self.d2 = np.asarray(d2, dtype=np.float64)

    @staticmethod
    def lift(x):
        return x if isinstance(x, _Dual) else _Dual(np.asarray(x, dtype=np.float64))

    def __add__(self, o):
        o = _Dual.lift(o)
        return _Dual(self.v + o.v, self.d1 + o.d1, self.d2 + o.d2)

    __radd__ = __add__

    def __neg__(self):
        return _Dual(-self.v, -self.d1, -self.d2)

    def __sub__(self, o):
        return self + (-_Dual.lift(o))

    def __rsub__(self, o):
        return _Dual.lift(o) + (-self)

    def __mul__(self, o):
        o = _Dual.lift(o)
        return _Dual(
            self.v * o.v,
            self.d1 * o.v + self.v * o.d1,
            self.d2 * o.v + self.v * o.d2,
        )

    __rmul__ = __mul__

    def __truediv__(self, c):
        # only division by constants appears in Lagrange bases
        c = float(c)
        return _Dual(self.v / c, self.d1 / c, self.d2 / c)


# ---------------------------------------------------------------------------
# Basis function definitions (node orderings match the reference element
# connectivity conventions, see mesh/midpoints.py and mesh/structured.py).
# ---------------------------------------------------------------------------
def _basis_p1(x1, x2):
    return [1 - x1 - x2, x1, x2]


def _basis_p2(x1, x2):
    x0 = 1 - x1 - x2
    return [
        x0 * (2 * x0 - 1),
        x1 * (2 * x1 - 1),
        x2 * (2 * x2 - 1),
        4 * x1 * x2,  # midpoint of edge (V2,V3)
        4 * x0 * x2,  # midpoint of edge (V3,V1)
        4 * x0 * x1,  # midpoint of edge (V1,V2)
    ]


def _basis_q1(x1, x2):
    return [
        (1 - x1) * (1 - x2) / 4,
        (1 + x1) * (1 - x2) / 4,
        (1 + x1) * (1 + x2) / 4,
        (1 - x1) * (1 + x2) / 4,
    ]


def _basis_q2(x1, x2):
    return [
        (1 - x1) * (1 - x2) * (-1 - x1 - x2) / 4,
        (1 + x1) * (1 - x2) * (-1 + x1 - x2) / 4,
        (1 + x1) * (1 + x2) * (-1 + x1 + x2) / 4,
        (1 - x1) * (1 + x2) * (-1 - x1 + x2) / 4,
        (1 - x1 * x1) * (1 - x2) / 2,  # bottom edge midpoint
        (1 + x1) * (1 - x2 * x2) / 2,  # right edge midpoint
        (1 - x1 * x1) * (1 + x2) / 2,  # top edge midpoint
        (1 - x1) * (1 - x2 * x2) / 2,  # left edge midpoint
    ]


def _basis_p4(x1, x2):
    """15-node quartic triangle.

    Node order (matches `create_midpoints_P4` connectivity layout,
    `tsx-tunnel/pythonFEM.py:1354-1505`):
      0-2   vertices V1 V2 V3
      3-5   edge midpoints: mid(V1V2), mid(V2V3), mid(V3V1)
      6-11  quarter points: (V1V2 near V1), (V1V2 near V2),
            (V2V3 near V2), (V2V3 near V3), (V3V1 near V3), (V3V1 near V1)
      12-14 interior points weighted toward V1, V2, V3
    """
    x0 = 1 - x1 - x2

    def vertex(a):
        return a * (4 * a - 1) * (4 * a - 2) * (4 * a - 3) / 6

    def mid(a, b):
        return 4 * a * b * (4 * a - 1) * (4 * b - 1)

    def quarter(a, b):
        # node at 3/4 toward `a` on edge (a,b)
        return 8 * a * b * (4 * a - 1) * (4 * a - 2) / 3

    def interior(a, b, c):
        return 32 * a * b * c * (4 * a - 1)

    return [
        vertex(x0),
        vertex(x1),
        vertex(x2),
        mid(x0, x1),
        mid(x1, x2),
        mid(x0, x2),
        quarter(x0, x1),
        quarter(x1, x0),
        quarter(x1, x2),
        quarter(x2, x1),
        quarter(x2, x0),
        quarter(x0, x2),
        interior(x0, x1, x2),
        interior(x1, x0, x2),
        interior(x2, x0, x1),
    ]


_VOLUME_BASIS = {
    ElementType.P1: _basis_p1,
    ElementType.P2: _basis_p2,
    ElementType.Q1: _basis_q1,
    ElementType.Q2: _basis_q2,
    ElementType.P4: _basis_p4,
}


# 1D edge bases on [-1, 1] -----------------------------------------------------
def _edge_linear(x):
    return [(1 - x) / 2, (1 + x) / 2]


def _edge_quadratic(x):
    return [x * (x - 1) / 2, x * (x + 1) / 2, (1 + x) * (1 - x)]


def _edge_quartic(x):
    """Lagrange basis on nodes (-1, 1, 0, -1/2, 1/2)."""
    nodes = [-1.0, 1.0, 0.0, -0.5, 0.5]
    out = []
    for i, xi in enumerate(nodes):
        num = _Dual.lift(1.0) if isinstance(x, _Dual) else 1.0
        for j, xj in enumerate(nodes):
            if j == i:
                continue
            num = num * ((x - xj) / 1.0) * (1.0 / (xi - xj))
        out.append(num)
    return out


_SURFACE_BASIS = {
    ElementType.P1: _edge_linear,
    ElementType.Q1: _edge_linear,
    ElementType.P2: _edge_quadratic,
    ElementType.Q2: _edge_quadratic,
    ElementType.P4: _edge_quartic,
}


# ---------------------------------------------------------------------------
# Quadrature rules (volume).  Constants as in the reference
# (`tsx-tunnel/pythonFEM.py:101-126`): P1 centroid, P2 7-point, Q1 2x2 Gauss,
# Q2 3x3 Gauss, P4 12-point (degree-6) rule.
# ---------------------------------------------------------------------------
def _volume_quadrature(etype: ElementType):
    pt = 1.0 / np.sqrt(3.0)
    if etype == ElementType.P1:
        xi = np.array([[1 / 3, 1 / 3]])
        w = np.array([0.5])
    elif etype == ElementType.P2:
        a, b = 0.1012865073235, 0.7974269853531
        c, d = 0.4701420641051, 0.0597158717898
        xi = np.array(
            [[a, a], [b, a], [a, b], [c, d], [c, c], [d, c], [1 / 3, 1 / 3]]
        )
        w = 0.5 * np.array(
            [
                0.1259391805448,
                0.1259391805448,
                0.1259391805448,
                0.1323941527885,
                0.1323941527885,
                0.1323941527885,
                0.225,
            ]
        )
    elif etype == ElementType.Q1:
        xi = np.array([[-pt, -pt], [-pt, pt], [pt, -pt], [pt, pt]])
        w = np.ones(4)
    elif etype == ElementType.Q2:
        xi = np.array(
            [
                [-pt, -pt],
                [pt, -pt],
                [pt, pt],
                [-pt, pt],
                [0, -pt],
                [pt, 0],
                [0, pt],
                [-pt, 0],
                [0, 0],
            ]
        )
        w = np.array([25, 25, 25, 25, 40, 40, 40, 40, 64]) / 81.0
    elif etype == ElementType.P4:
        # Degree-6 12-point symmetric rule.  The reference transcribes one
        # coordinate as 0.06308901449102 (missing digit,
        # `tsx-tunnel/pythonFEM.py:115`); we use the symmetric exact value.
        g1a, g1b = 0.063089014491502, 0.873821971016996
        g2a, g2b = 0.249286745170910, 0.501426509658179
        g3a, g3b, g3c = 0.310352451033785, 0.053145049844816, 0.636502499121399
        xi = np.array(
            [
                [g1a, g1a],
                [g1a, g1b],
                [g1b, g1a],
                [g2a, g2a],
                [g2a, g2b],
                [g2b, g2a],
                [g3a, g3b],
                [g3a, g3c],
                [g3b, g3a],
                [g3b, g3c],
                [g3c, g3a],
                [g3c, g3b],
            ]
        )
        w = (
            np.array(
                [
                    0.050844906370207,
                    0.050844906370207,
                    0.050844906370207,
                    0.116786275726379,
                    0.116786275726379,
                    0.116786275726379,
                    0.082851075618374,
                    0.082851075618374,
                    0.082851075618374,
                    0.082851075618374,
                    0.082851075618374,
                    0.082851075618374,
                ]
            )
            / 2.0
        )
    else:  # pragma: no cover
        raise ValueError(f"unknown element type {etype}")
    return xi.astype(np.float64), w.astype(np.float64)


def _surface_quadrature(etype: ElementType):
    pt = 1.0 / np.sqrt(3.0)
    if etype in (ElementType.P1, ElementType.Q1):
        xi = np.array([0.0])
        w = np.array([2.0])
    elif etype in (ElementType.P2, ElementType.Q2):
        xi = np.array([-pt, pt])
        w = np.array([1.0, 1.0])
    elif etype == ElementType.P4:
        # 5-point Gauss-Legendre: exact to polynomial degree 9
        x, w = np.polynomial.legendre.leggauss(5)
        xi = x.astype(np.float64)
        w = w.astype(np.float64)
    else:  # pragma: no cover
        raise ValueError(f"unknown element type {etype}")
    return xi.astype(np.float64), w.astype(np.float64)


# ---------------------------------------------------------------------------
# Public table containers
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ReferenceElement:
    """Volume reference-element data.

    Attributes:
      etype:  element family
      xi:     quadrature points, shape (n_q, 2)
      w:      quadrature weights, shape (n_q,)
      N:      basis values at quadrature points, shape (n_q, n_p)
      dN:     basis gradients at quadrature points, shape (n_q, n_p, 2)
    """

    etype: ElementType
    xi: np.ndarray
    w: np.ndarray
    N: np.ndarray
    dN: np.ndarray

    @property
    def n_q(self) -> int:
        return self.xi.shape[0]

    @property
    def n_p(self) -> int:
        return self.N.shape[1]


@dataclass(frozen=True)
class SurfaceElement:
    """Edge (surface) reference-element data.

    Attributes:
      xi:  1D quadrature points on [-1, 1], shape (n_q,)
      w:   quadrature weights, shape (n_q,)
      N:   basis values, shape (n_q, n_p)
      dN:  basis xi-derivatives, shape (n_q, n_p)
    """

    etype: ElementType
    xi: np.ndarray
    w: np.ndarray
    N: np.ndarray
    dN: np.ndarray

    @property
    def n_q(self) -> int:
        return self.xi.shape[0]

    @property
    def n_p(self) -> int:
        return self.N.shape[1]


class ElementTables(NamedTuple):
    """Pytree view of `ReferenceElement` for passing through jit boundaries.

    Element tables are passed as jit *arguments*, not embedded as program
    constants (`utils/jitsafe.py`); this NamedTuple is the pytree
    carrier.
    """

    xi: object
    w: object
    N: object
    dN: object

    @property
    def n_q(self) -> int:
        return self.w.shape[0]

    @property
    def n_p(self) -> int:
        return self.N.shape[1]


def tables(ref) -> ElementTables:
    """ReferenceElement/SurfaceElement -> jit-passable pytree of arrays."""
    return ElementTables(xi=ref.xi, w=ref.w, N=ref.N, dN=ref.dN)


def volume_element(etype: ElementType) -> ReferenceElement:
    """Build the volume reference-element tables for `etype`."""
    xi, w = _volume_quadrature(etype)
    fn = _VOLUME_BASIS[etype]
    x1 = _Dual(xi[:, 0], np.ones(len(xi)), np.zeros(len(xi)))
    x2 = _Dual(xi[:, 1], np.zeros(len(xi)), np.ones(len(xi)))
    vals = fn(x1, x2)
    N = np.stack([np.broadcast_to(v.v, (len(xi),)) for v in vals], axis=1)
    dN = np.stack(
        [
            np.stack(
                [
                    np.broadcast_to(v.d1, (len(xi),)),
                    np.broadcast_to(v.d2, (len(xi),)),
                ],
                axis=-1,
            )
            for v in vals
        ],
        axis=1,
    )
    return ReferenceElement(etype, xi, w, N, dN)


def surface_element(etype: ElementType) -> SurfaceElement:
    """Build the edge reference-element tables for `etype`."""
    xi, w = _surface_quadrature(etype)
    fn = _SURFACE_BASIS[etype]
    x = _Dual(xi, np.ones(len(xi)), np.zeros(len(xi)))
    vals = fn(x)
    N = np.stack([np.broadcast_to(v.v, (len(xi),)) for v in vals], axis=1)
    dN = np.stack([np.broadcast_to(v.d1, (len(xi),)) for v in vals], axis=1)
    return SurfaceElement(etype, xi, w, N, dN)
