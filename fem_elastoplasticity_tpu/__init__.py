"""fem_elastoplasticity_tpu — a 2D FEM elastoplasticity framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
MartinBeseda/FEM-ElastoPlasticity (plane-strain linear elasticity and
Drucker-Prager elastoplasticity with load-stepped semi-smooth Newton):

* element-batched assembly (einsum + segment_sum) instead of scipy sparse,
* branchless Drucker-Prager return mapping,
* the entire load-stepping Newton loop under one `jit`
  (`lax.while_loop`, no host round-trips),
* matrix-free preconditioned CG for large meshes, masked dense
  Cholesky/LU for reference-parity on small ones,
* `shard_map` element / operator-row partitioning across devices and `vmap`
  material-parameter ensembles.
"""
from .utils.precision import enable_x64 as _enable_x64

_enable_x64()

from .ops.elements import ElementType, volume_element, surface_element  # noqa: E402
from .mesh.structured import Mesh, square_mesh, square_with_hole_mesh  # noqa: E402
from .mesh.io import load_csv_mesh  # noqa: E402
from .mesh.midpoints import promote  # noqa: E402
from .mesh.refine import refine_mesh, refine_uniform  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ElementType",
    "volume_element",
    "surface_element",
    "Mesh",
    "square_mesh",
    "square_with_hole_mesh",
    "load_csv_mesh",
    "promote",
    "refine_mesh",
    "refine_uniform",
]
