"""Inverse-distance-weighting node interpolation — batched device kernel.

Behavioral rebuild of ninpol/_methods/idw.pyx:35-84:
  * weight_j = (1/dist(node, centroid_j)) / sum_k 1/dist, over the node's
    surrounding cells in esup order,
  * exact-hit: the FIRST cell with squared distance <= float32(1e-15)
    gets weight 1 and all others 0 (idw.pyx:69-74),
  * Dirichlet boundary nodes (boundary and not Neumann) are skipped
    (idw.pyx:62-63) and never write the Neumann vector,
  * distances use only the first ``dim`` coordinates (idw.pyx:66-67).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

_EXACT_EPS = float(np.float32(1e-15))  # idw.pyx:53 (C float of 1e-15)


def _simple_gather(nodes, valid, esup2d, esup_cnt, point_pack,
                   cell_pack, *, E):
    """Stencil gather shared by the simple (IDW/LS) kernels — pure data
    movement + mask logic, no float arithmetic, so the split and fused
    compositions are bit-identical.  Its output is a pure function of
    (grid geometry, bucket plan), so the drivers hoist them out of the
    solve and cache the tiles on the plan's unit dicts (shared between
    IDW and LS — the plan cache is content-keyed, and the gather is
    method-independent)."""
    KSetv = esup2d[nodes, :E]
    n_elem = jnp.minimum(esup_cnt[nodes], E)
    cell_valid = (jnp.arange(E)[None, :] < n_elem[:, None]) & (KSetv >= 0)
    KS = jnp.where(cell_valid, KSetv, 0)
    return (point_pack[nodes], cell_pack[KS], cell_valid, n_elem, valid)


_simple_gather_j = partial(
    jax.jit, static_argnames=("E",))(_simple_gather)


@partial(jax.jit, static_argnames=("E",))
def _simple_gather_scan(nodes_s, valid_s, esup2d, esup_cnt, point_pack,
                        cell_pack, *, E):
    def body(c, nv):
        nodes, valid = nv
        return c, _simple_gather(nodes, valid, esup2d, esup_cnt,
                                 point_pack, cell_pack, E=E)

    _, tiles = jax.lax.scan(body, 0, (nodes_s, valid_s))
    return tiles


def _idw_math(tiles, *, dim):
    """IDW weights from pre-gathered tiles; hi + lo reconstructs the
    float64 coordinates bit-exactly, so the distance math stays
    reference-f64."""
    f64 = jnp.float64
    pp, cp, cell_valid, _n_elem, valid = tiles
    E = cp.shape[1]
    xv = (pp[:, 0:3].astype(f64) + pp[:, 3:6].astype(f64))[:, :dim]
    xc = (cp[:, :, 0:3].astype(f64)
          + cp[:, :, 3:6].astype(f64))[:, :, :dim]
    d2 = jnp.sum((xv[:, None, :] - xc) ** 2, axis=2)          # (B,E)

    hit = cell_valid & (d2 <= _EXACT_EPS)
    any_hit = jnp.any(hit, axis=1)
    first_hit = jnp.argmax(hit, axis=1)

    d = jnp.sqrt(jnp.where(cell_valid, d2, 1.0))
    inv = jnp.where(cell_valid, 1.0 / d, 0.0)
    w = inv / jnp.sum(inv, axis=1, keepdims=True)

    onehot = (jnp.arange(E)[None, :] == first_hit[:, None]).astype(w.dtype)
    w = jnp.where(any_hit[:, None], onehot, w)
    return jnp.where(valid[:, None] & cell_valid, w, 0.0)


def _idw_bucket_impl(nodes, valid, esup2d, esup_cnt,
                     point_pack, cell_pack, *, E, dim):
    # single-program composition (sharded/legacy paths); the default
    # driver runs _simple_gather as its own cached program instead
    return _idw_math(_simple_gather(nodes, valid, esup2d, esup_cnt,
                                    point_pack, cell_pack, E=E), dim=dim)


_idw_bucket_kernel = partial(
    jax.jit, static_argnames=("E", "dim"))(_idw_bucket_impl)
_idw_math_j = partial(jax.jit, static_argnames=("dim",))(_idw_math)


@partial(jax.jit, static_argnames=("dim",))
def _idw_math_scan(tiles_s, *, dim):
    def body(c, tiles):
        return c, _idw_math(tiles, dim=dim)

    _, w = jax.lax.scan(body, 0, tiles_s)
    S, B = w.shape[0], w.shape[1]
    return w.reshape(S * B, w.shape[2])


# Scan-stacked entry: S identical-shape chunks run as ONE program (see
# _methods/gls.py): one dispatch and one executable instead of S.
@partial(jax.jit, static_argnames=("E", "dim"))
def _idw_bucket_scan(nodes_s, valid_s, esup2d, esup_cnt,
                     point_pack, cell_pack, *, E, dim):
    def body(c, nv):
        nodes, valid = nv
        return c, _idw_bucket_impl(nodes, valid, esup2d, esup_cnt,
                                   point_pack, cell_pack, E=E, dim=dim)

    _, w = jax.lax.scan(body, 0, (nodes_s, valid_s))
    S, B = nodes_s.shape
    return w.reshape(S * B, w.shape[2])


# The fused device_out plan for the simple (IDW/LS) kernels: every scan
# unit AND the delivery consolidation in ONE program, so short kernels
# do not leave the device idle between dispatches (unlike GLS, whose
# fused plan stays opt-in).  Neither choice is measured on the H100 yet.
def _simple_math(name):
    if name == "idw":
        return _idw_math
    from .ls import _ls_math
    return _ls_math


def simple_pregather_on(units):
    """Shared pre-gather gate for the simple drivers: kill switch plus a
    device-memory budget, NINPOL_TPU_PREGATHER_GB (tiles cost ~25E+29
    bytes per padded node — ~240 B at hexa E=8, ~630 B at tetra E=24)."""
    import os as _os
    if _os.environ.get("NINPOL_TPU_NO_PREGATHER") == "1":
        return False
    est = sum(len(p["pos"]) * (25 * p["E"] + 29) for _, p in units)
    return est <= float(_os.environ.get(
        "NINPOL_TPU_PREGATHER_GB", "6")) * 1e9


def simple_gather_tiles(unit, dgrid):
    """Pre-gathered tiles for one unit, cached on the unit dict: pure
    grid geometry (no variable data), so the cache needs no version
    key and is SHARED between IDW and LS (the content-keyed plan cache
    hands both methods the same dicts for identical target/mask)."""
    kind, p = unit
    tiles = p.get("_stiles")
    if tiles is not None:
        return tiles
    if kind == "scan":
        tiles = _simple_gather_scan(
            p["nodes_sd"], p["valid_sd"], dgrid.esup2d, dgrid.esup_cnt,
            dgrid.point_pack, dgrid.cell_pack, E=p["E"])
    else:
        from .device_grid import bucket_dev
        tiles = _simple_gather_j(
            *bucket_dev(p), dgrid.esup2d, dgrid.esup_cnt,
            dgrid.point_pack, dgrid.cell_pack, E=p["E"])
    p["_stiles"] = tiles
    return tiles


@partial(jax.jit, static_argnames=("impl_name", "plan_sig", "statics",
                                   "n_target", "ncols_out"))
def _run_simple_plan_device(tiles_list, pos_flat, *, impl_name,
                            plan_sig, statics, n_target, ncols_out):
    from .device_grid import _deliver_device_j
    impl = _simple_math(impl_name)
    rows = []
    for (E, S, B), tiles in zip(plan_sig, tiles_list):
        kw = dict(statics)
        if S == 1:
            w = impl(tiles, **kw)
        else:
            def body(c, t, kw=kw):
                return c, impl(t, **kw)
            _, w = jax.lax.scan(body, 0, tiles)
            w = w.reshape(S * B, w.shape[2])
        rows.append(w)
    return _deliver_device_j(tuple(rows), pos_flat, n_target=n_target,
                             ncols_out=ncols_out)


def run_simple_device_plan(units, dgrid, impl_name, statics, n_target,
                           ncols_out):
    """device_out driver for the fused simple plan (shared by IDW/LS):
    the whole math plan + delivery consolidation runs as ONE program
    over the PRE-GATHERED tiles (the stencil gathers dominated device
    time at 2M-point scale; they now run once per plan as their own
    cached programs — simple_gather_tiles).  Returns the consolidated
    (n_target, ncols_out + 1) float64 device array."""
    import jax.numpy as _jnp
    from .device_grid import plan_pos_flat
    if not units:
        return _jnp.zeros((n_target, ncols_out + 1), _jnp.float64)
    plan_sig, tl = [], []
    for kind, p in units:
        S = p["S"] if kind == "scan" else 1
        plan_sig.append((p["E"], S, len(p["pos"]) // S))
        tl.append(simple_gather_tiles((kind, p), dgrid))
    pos_flat = plan_pos_flat([p for _, p in units], n_target)
    return _run_simple_plan_device(
        tuple(tl), pos_flat,
        impl_name=impl_name, plan_sig=tuple(plan_sig), statics=statics,
        n_target=n_target, ncols_out=ncols_out)


def shard_nodes(mesh, bucket):
    """(nodes, valid) device_put with the node axis partitioned over the
    mesh — the geometry-sharded (GSPMD) path's bucket placement."""
    from jax.sharding import NamedSharding, PartitionSpec
    nsh = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
    return (jax.device_put(jnp.asarray(bucket["nodes"]), nsh),
            jax.device_put(jnp.asarray(bucket["valid"]), nsh))


def sharded_simple_kernel(impl, mesh, statics, n_rep, cache={}):
    """jit(shard_map(impl)) with (nodes, valid) sharded over the mesh
    axis and ``n_rep`` trailing grid arrays replicated — shared by the
    IDW/LS drivers (see gls._gls_bucket_sharded for the GLS variant)."""
    key = (impl, mesh, statics)
    fn = cache.get(key)
    if fn is None:
        from jax.sharding import PartitionSpec as P
        axis = mesh.axis_names[0]
        nspec = P(axis)
        fn = jax.jit(jax.shard_map(
            partial(impl, **dict(statics)), mesh=mesh,
            in_specs=(nspec, nspec) + (P(),) * n_rep,
            out_specs=nspec))
        cache[key] = fn
    return fn


class IDWInterpolation:
    """Driver matching the reference prepare() contract (idw.pyx:14-30)."""

    def __init__(self, logging=False):
        self.logging = logging
        # f32 host delivery (documented non-parity knob): halves the
        # device->host bytes at the cost of ~1e-7 relative weight
        # rounding.  Set through
        # Interpolator.delivery_f32.
        self.delivery_f32 = False
        # node-chunk quantum (tests shrink it to force multi-chunk
        # plans; see gls.chunk_nodes for the GLS analogue)
        self.chunk_nodes = 131072

    def prepare(self, dgrid, cells_data, points_data, faces_data,
                variable_to_index, variable, target_points,
                weights, neumann_ws, device_out=False):
        grid = dgrid.grid
        nf_idx = variable_to_index["points"]["neumann_flag_" + variable]
        neumann_flag = points_data[nf_idx].astype(np.int64)

        from .device_grid import (build_scan_units, bucket_dev,
                                  deliver_weights,
                                  dispatch_units_with_preload)
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
                nv = shard_nodes(mesh, bucket)
            else:
                nv = (bucket["nodes"], bucket["valid"])
            args = (*nv,
                    dgrid.esup2d, dgrid.esup_cnt,
                    dgrid.point_pack, dgrid.cell_pack)
            if mesh is None or shard_geo:
                # shard_geo: GSPMD auto-partitioning over the sharded
                # inputs (XLA inserts the stencil-gather collectives)
                return _idw_bucket_kernel(*args, E=bucket["E"],
                                          dim=grid.dim)
            return sharded_simple_kernel(
                _idw_bucket_impl, mesh,
                (("E", bucket["E"]), ("dim", grid.dim)), 4)(*args)

        def run_unit(unit):
            kind, b = unit
            if pregather:
                tiles = simple_gather_tiles(unit, dgrid)
                if kind == "scan":
                    return _idw_math_scan(tiles, dim=grid.dim)
                return _idw_math_j(tiles, dim=grid.dim)
            if kind == "single":
                return run(b)
            return _idw_bucket_scan(b["nodes_sd"], b["valid_sd"],
                                    dgrid.esup2d, dgrid.esup_cnt,
                                    dgrid.point_pack, dgrid.cell_pack,
                                    E=b["E"], dim=grid.dim)

        # column padding to ncols_out happens inside the jitted
        # delivery consolidation (device_grid.deliver_weights)
        if mesh is None:
            import os as _os
            units = (build_scan_units(buckets)
                     if _os.environ.get("NINPOL_TPU_NO_SCAN") != "1"
                     else [("single", b) for b in buckets])
            pregather = simple_pregather_on(units)
            if device_out and pregather:
                # whole math plan + delivery in ONE program over cached
                # pre-gathered tiles (see _run_simple_plan_device)
                return run_simple_device_plan(
                    units, dgrid, "idw", (("dim", grid.dim),),
                    len(target_points), weights.shape[1])
            launched = dispatch_units_with_preload(
                units, run_unit, len(target_points), weights.shape[1],
                device_out, self.delivery_f32)
        else:
            launched = [(b, run(b)) for b in buckets]
        return deliver_weights(launched, weights, neumann_ws,
                               len(target_points), device_out,
                               self.delivery_f32)
