"""Benchmark / cross-validation harnesses.

Analog of the reference's MATLAB-engine comparison script
(`Elasticity2D/comparison_assembly_P1_2D_elasticity.py`): refinement-level
assembly sweeps, full-solve scaling sweeps, and material ensembles, all
self-contained (the in-repo oracle is the golden-file + anchor test suite
rather than a MATLAB session).
"""
from .assembly_sweep import run_assembly_sweep
from .solve_sweep import run_solve_sweep
from .ensemble_bench import run_ensemble_bench
