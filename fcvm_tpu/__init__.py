"""fcvm_tpu: finite-element collapse analysis on JAX/XLA accelerators.

A ground-up JAX/XLA rebuild of the capabilities of the fcVM-workbench
(von Mises elastoplastic collapse analysis of tet10 meshes with optional
geometric nonlinearity, Riks arc-length control, linear buckling and
imperfection seeding, damage/ductility tracking, and full post-processing).

Architecture (accelerator-first, not a port):

* Element integration, stress return and damage updates are batched over all
  (element, gauss-point) pairs with ``vmap`` + ``jit`` so the device sees one
  large regular computation instead of the reference's sequential numba loops
  (reference: ``source code/fcVM.py:620-816, 2196-2492``).
* The sparse direct Cholesky backends of the reference
  (``source code/fcVM.py:66-71``) are replaced by a device-resident matrix-free
  preconditioned conjugate-gradient solver: gather -> per-element 30x30 block
  matmul -> scatter-add (``fcvm_tpu.ops.solver``).
* Multi-chip scaling shards the element partition over a
  ``jax.sharding.Mesh`` with ``shard_map`` and ``psum`` for the node-boundary
  reduction (``fcvm_tpu.parallel``); no NCCL/MPI-style transport is needed.

Public API: see :mod:`fcvm_tpu.api`.
"""

from fcvm_tpu.version import __version__

from fcvm_tpu.config import FcvmConfig, get_config, set_config
from fcvm_tpu.models.spec import (
    Mesh,
    Material,
    BoundaryConditions,
    Loads,
    Model,
)
from fcvm_tpu.models.inp import ControlParams, read_inp, write_inp
from fcvm_tpu.runtime.driver import solve_collapse, AnalysisResults
from fcvm_tpu.runtime.buckling import linear_buckling
from fcvm_tpu.api import run_analysis, run_sum

__all__ = [
    "__version__",
    "FcvmConfig",
    "get_config",
    "set_config",
    "Mesh",
    "Material",
    "BoundaryConditions",
    "Loads",
    "Model",
    "ControlParams",
    "read_inp",
    "write_inp",
    "solve_collapse",
    "AnalysisResults",
    "linear_buckling",
    "run_analysis",
    "run_sum",
]
