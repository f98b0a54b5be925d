"""ninpol_tpu: nodal interpolation for finite-volume schemes in JAX.

A ground-up JAX/XLA rebuild of the capabilities of ninpol (nodal
interpolation weights for MPFA-D finite-volume pressure solvers on
unstructured meshes): given a mesh and a cell-centered variable, compute
per-node weights over surrounding cells plus Neumann boundary corrections,
returned as a scipy CSR matrix (reference: README.md:20-34,
ninpol/__init__.py:1-3).
"""
import os as _os

import jax as _jax

# This is a float64 numerical library (the reference is float64
# throughout); JAX defaults to 32-bit unless x64 is enabled, which would
# silently truncate every array and destroy the 1e-10 parity contract.
_jax.config.update("jax_enable_x64", True)

# The CholQR2 preconditioner needs true float32 matmuls: the GPU default
# may run float32 products in TF32 (~1e-3 relative), so raise the
# default for this process.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: kernel shapes recur across runs (stencil
# buckets are rounded to coarse classes for exactly this reason).  JAX
# itself honours JAX_COMPILATION_CACHE_DIR; otherwise the cache lives at
# a fixed path in the checkout (the path is part of the cache key).
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
# 0: persist EVERY compiled program, the cheap consolidation programs
# included.
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from .interpolator import Interpolator
from ._grid.grid import Grid
from ._io.mesh import Mesh, CellBlock, read as read_mesh, write as write_mesh

__version__ = "0.1.0"
__all__ = ["Interpolator", "Grid", "Mesh", "CellBlock", "read_mesh",
           "write_mesh"]
