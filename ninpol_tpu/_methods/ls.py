"""Least-squares (linear-fit) node interpolation — batched device kernel.

Behavioral rebuild of ninpol/_methods/ls.pyx:33-136: an unweighted linear
least-squares fit over the surrounding cell centroids, solved with the
hand-rolled 3x3 cofactor formulas of the reference:

  * moments Ix..Izz of the centroid offsets (ls.pyx:64-77),
  * 2D degeneracy guard: Izz=1 when all z-moments vanish (ls.pyx:79-80),
  * lambda_x/y/z via the cofactor expressions (ls.pyx:108-124) —
    reproduced verbatim so roundoff matches,
  * weight_i = (1 + lambda . dv_i) / (n + lambda . I) (ls.pyx:126-136),
  * D == 0 -> plain inverse-distance fallback weights (ls.pyx:88-102;
    note: unlike IDW there is no exact-hit handling, distances use all 3
    coordinates),
  * Dirichlet boundary nodes skipped (ls.pyx:58-59).

Exact for linear fields; never writes the Neumann vector.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def _ls_math(tiles):
    """LS weights from pre-gathered tiles (idw._simple_gather); hi + lo
    reconstructs float64 bit-exactly (see _methods/idw.py)."""
    f64 = jnp.float64
    pp, cp, cell_valid, n_elem, valid = tiles
    xv = pp[:, 0:3].astype(f64) + pp[:, 3:6].astype(f64)      # (B,3)
    cen = cp[:, :, 0:3].astype(f64) + cp[:, :, 3:6].astype(f64)
    dv = jnp.where(cell_valid[:, :, None],
                   cen - xv[:, None, :], 0.0)                 # (B,E,3)

    Ix = jnp.sum(dv[:, :, 0], axis=1)
    Iy = jnp.sum(dv[:, :, 1], axis=1)
    Iz = jnp.sum(dv[:, :, 2], axis=1)
    Ixx = jnp.sum(dv[:, :, 0] * dv[:, :, 0], axis=1)
    Ixy = jnp.sum(dv[:, :, 0] * dv[:, :, 1], axis=1)
    Ixz = jnp.sum(dv[:, :, 0] * dv[:, :, 2], axis=1)
    Iyy = jnp.sum(dv[:, :, 1] * dv[:, :, 1], axis=1)
    Iyz = jnp.sum(dv[:, :, 1] * dv[:, :, 2], axis=1)
    Izz = jnp.sum(dv[:, :, 2] * dv[:, :, 2], axis=1)

    guard = (Iz == 0.0) & (Izz == 0.0) & (Ixz == 0.0) & (Iyz == 0.0)
    Izz = jnp.where(guard, 1.0, Izz)                          # ls.pyx:79-80

    D = (Ixx * (Iyy * Izz - Iyz * Iyz)
         + Ixy * (Iyz * Ixz - Ixy * Izz)
         + Ixz * (Ixy * Iyz - Iyy * Ixz))

    # Degeneracy test.  The reference compares D == 0.0 exactly
    # (ls.pyx:88), which at rank-deficient stencils depends on summation
    # rounding luck; a threshold relative to the term magnitudes makes the
    # branch deterministic and only differs where the reference output is
    # itself arbitrary.
    Dabs = (jnp.abs(Ixx) * (jnp.abs(Iyy * Izz) + Iyz * Iyz)
            + jnp.abs(Ixy) * (jnp.abs(Iyz * Ixz) + jnp.abs(Ixy * Izz))
            + jnp.abs(Ixz) * (jnp.abs(Ixy * Iyz) + jnp.abs(Iyy * Ixz)))
    is_degen = jnp.abs(D) <= 1e-12 * Dabs
    Dsafe = jnp.where(is_degen, 1.0, D)
    lx = (Ix * (Iyz * Iyz - Iyy * Izz)
          + Iy * (Ixy * Izz - Iyz * Ixz)
          + Iz * (Iyy * Ixz - Ixy * Iyz)) / Dsafe
    ly = (Ix * (Ixy * Izz - Iyz * Ixz)
          + Iy * (Ixz * Ixz - Ixx * Izz)
          + Iz * (Ixx * Iyz - Ixy * Ixz)) / Dsafe
    lz = (Ix * (Iyy * Ixz - Ixy * Iyz)
          + Iy * (Ixx * Iyz - Ixy * Ixz)
          + Iz * (Ixy * Ixy - Ixx * Iyy)) / Dsafe

    denom = (n_elem.astype(dv.dtype)
             + lx * Ix + ly * Iy + lz * Iz)
    w_ls = (1.0 + lx[:, None] * dv[:, :, 0]
            + ly[:, None] * dv[:, :, 1]
            + lz[:, None] * dv[:, :, 2]) / denom[:, None]

    # D == 0 fallback: plain 1/dist normalization (ls.pyx:88-102)
    dist = jnp.sqrt(jnp.sum(dv * dv, axis=2))
    inv = jnp.where(cell_valid, 1.0 / jnp.where(cell_valid, dist, 1.0), 0.0)
    w_idw = inv / jnp.sum(inv, axis=1, keepdims=True)

    w = jnp.where(is_degen[:, None], w_idw, w_ls)
    return jnp.where(valid[:, None] & cell_valid, w, 0.0)


def _ls_bucket_impl(nodes, valid, esup2d, esup_cnt,
                    point_pack, cell_pack, *, E):
    # single-program composition (sharded/legacy paths); the default
    # driver runs the gather as its own cached program instead
    from .idw import _simple_gather
    return _ls_math(_simple_gather(nodes, valid, esup2d, esup_cnt,
                                   point_pack, cell_pack, E=E))


_ls_bucket_kernel = partial(jax.jit, static_argnames=("E",))(_ls_bucket_impl)
_ls_math_j = jax.jit(_ls_math)


@jax.jit
def _ls_math_scan(tiles_s):
    def body(c, tiles):
        return c, _ls_math(tiles)

    _, w = jax.lax.scan(body, 0, tiles_s)
    S, B = w.shape[0], w.shape[1]
    return w.reshape(S * B, w.shape[2])


# Scan-stacked entry (see _methods/idw.py — kills the ~30 ms/dispatch
# gaps and the per-chunk program loads at 2M-point scale)
@partial(jax.jit, static_argnames=("E",))
def _ls_bucket_scan(nodes_s, valid_s, esup2d, esup_cnt,
                    point_pack, cell_pack, *, E):
    def body(c, nv):
        nodes, valid = nv
        return c, _ls_bucket_impl(nodes, valid, esup2d, esup_cnt,
                                  point_pack, cell_pack, E=E)

    _, w = jax.lax.scan(body, 0, (nodes_s, valid_s))
    S, B = nodes_s.shape
    return w.reshape(S * B, w.shape[2])


class LSInterpolation:
    """Driver matching the reference prepare() contract (ls.pyx:21-31)."""

    def __init__(self, logging=False):
        self.logging = logging
        # see IDWInterpolation.delivery_f32 / chunk_nodes
        self.delivery_f32 = False
        self.chunk_nodes = 131072

    def prepare(self, dgrid, cells_data, points_data, faces_data,
                variable_to_index, variable, target_points,
                weights, neumann_ws, device_out=False):
        from .device_grid import (build_scan_units, bucket_dev,
                                  deliver_weights,
                                  dispatch_units_with_preload)
        grid = dgrid.grid
        nf_idx = variable_to_index["points"]["neumann_flag_" + variable]
        neumann_flag = points_data[nf_idx].astype(np.int64)

        target_points = np.asarray(target_points)
        active = ~(grid.boundary_points[target_points].astype(bool)
                   & (neumann_flag[target_points] == 0))

        mesh = getattr(dgrid, "mesh", None)
        balign = 256 if mesh is None else max(256, 128 * mesh.devices.size)
        buckets = dgrid.buckets(target_points, active, need_faces=False,
                                chunk_size=self.chunk_nodes,
                                batch_align=balign)

        shard_geo = getattr(dgrid, "shard_geometry", False)
        pregather = False             # set for the mesh is None path below

        def run(bucket):
            if mesh is None:
                nv = bucket_dev(bucket)
            elif shard_geo:
                from .idw import shard_nodes
                nv = shard_nodes(mesh, bucket)
            else:
                nv = (bucket["nodes"], bucket["valid"])
            args = (*nv,
                    dgrid.esup2d, dgrid.esup_cnt,
                    dgrid.point_pack, dgrid.cell_pack)
            if mesh is None or shard_geo:
                return _ls_bucket_kernel(*args, E=bucket["E"])
            from .idw import sharded_simple_kernel
            return sharded_simple_kernel(
                _ls_bucket_impl, mesh, (("E", bucket["E"]),), 4)(*args)

        def run_unit(unit):
            kind, b = unit
            if pregather:
                from .idw import simple_gather_tiles
                tiles = simple_gather_tiles(unit, dgrid)
                if kind == "scan":
                    return _ls_math_scan(tiles)
                return _ls_math_j(tiles)
            if kind == "single":
                return run(b)
            return _ls_bucket_scan(b["nodes_sd"], b["valid_sd"],
                                   dgrid.esup2d, dgrid.esup_cnt,
                                   dgrid.point_pack, dgrid.cell_pack,
                                   E=b["E"])

        # column padding to ncols_out happens inside the jitted
        # delivery consolidation (device_grid.deliver_weights)
        if mesh is None:
            import os as _os
            units = (build_scan_units(buckets)
                     if _os.environ.get("NINPOL_TPU_NO_SCAN") != "1"
                     else [("single", b) for b in buckets])
            from .idw import run_simple_device_plan, simple_pregather_on
            pregather = simple_pregather_on(units)
            if device_out and pregather:
                # whole math plan + delivery in ONE program over cached
                # pre-gathered tiles (see idw._run_simple_plan_device)
                return run_simple_device_plan(
                    units, dgrid, "ls", (), len(target_points),
                    weights.shape[1])
            launched = dispatch_units_with_preload(
                units, run_unit, len(target_points), weights.shape[1],
                device_out, self.delivery_f32)
        else:
            launched = [(b, run(b)) for b in buckets]
        return deliver_weights(launched, weights, neumann_ws,
                               len(target_points), device_out,
                               self.delivery_f32)
