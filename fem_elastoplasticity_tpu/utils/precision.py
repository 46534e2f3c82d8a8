"""Precision policy.

Validation parity with the reference requires float64
(SURVEY.md §7 "Hard parts"): Newton tolerances of 1e-12 and golden-file
agreement at 1e-8 rel are unreachable in float32.  The f32 / double-float
fast paths are opt-in per problem config.

Importing anything from `fem_elastoplasticity_tpu` enables x64 unless
`FEM_NO_X64=1` is set in the environment.
"""
from __future__ import annotations

import os


def enable_x64() -> None:
    # XLA:CPU's MLIR fusion emitters miscompile compensated (double-float)
    # arithmetic: a large fused chain of two_sum/two_prod transforms loses
    # its compensation terms (measured in this repo: the df32 Newton
    # residual floor degrades 1e-13 -> 1e-6; single ops and small fusions
    # are exact; `--xla_cpu_use_fusion_emitters=false` restores exactness,
    # no fast-math flag is involved).  The flag only affects the CPU
    # backend (tests / virtual meshes); a GPU process accepts and ignores
    # it.  Must be set before the first backend initialization.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_use_fusion_emitters" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_cpu_use_fusion_emitters=false"
        ).strip()

    import jax

    # f32 matmuls may otherwise run in TF32 on the GPU (~3 decimal
    # digits); FEM conditioning needs true f32 products
    jax.config.update("jax_default_matmul_precision", "highest")
    if os.environ.get("FEM_NO_X64") == "1":
        return
    jax.config.update("jax_enable_x64", True)
