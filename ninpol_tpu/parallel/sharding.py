"""Multi-chip scaling over a JAX device mesh.

The reference's only parallelism is intra-process OpenMP over nodes
(SURVEY.md §2.3); the analogue here is:

  * single chip: the batched/bucketed kernels (vmap-style) — done in
    _methods/*,
  * multi chip: shard the NODE axis of each bucket across a 1D device
    mesh (the GPUs of one host reach each other at the same NVLink
    rate, so the mesh follows the algorithm alone).  Per-node weights
    are node-local, so the only communication is the gather of
    cell/face geometry referenced by a shard's stencils.  Sharding the
    geometry arrays too (memory scaling for huge meshes) makes XLA
    insert the all-gathers automatically; keeping them replicated
    makes every gather local.

``shard_interpolate`` wraps a bucket kernel in ``jax.jit`` with explicit
NamedSharding annotations instead of translating the reference's OpenMP
loops (grid.pyx prange) into collectives — XLA owns the partitioning.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, axis="nodes"):
    """1D device mesh over the node axis (all devices by default).

    Raises ValueError when fewer than ``n_devices`` devices exist: a
    silently smaller mesh would hide the missing devices."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"mesh of {n_devices} devices requested, but only "
                f"{len(devs)} {devs[0].platform} device(s) exist")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def node_sharding(mesh, axis="nodes"):
    return NamedSharding(mesh, P(axis))


def replicated(mesh):
    return NamedSharding(mesh, P())


def shard_bucket_arrays(mesh, nodes, valid, axis="nodes"):
    """Place a bucket's per-node arrays on the mesh, padding the batch to a
    multiple of the mesh size (buckets are already 256-aligned, so any
    mesh up to 256 devices divides evenly)."""
    sh = node_sharding(mesh, axis)
    return (jax.device_put(nodes, sh), jax.device_put(valid, sh))


def sharded_gls(dgrid, mesh, shard_geometry=False, axis="nodes"):
    """Return a function running the GLS bucket kernel with the node batch
    sharded over ``mesh``.

    shard_geometry=True also shards the big per-cell/per-face arrays
    (centroids, permeability, ...) across devices — XLA then inserts the
    all-gather collectives for the stencil gathers; use for meshes whose
    geometry exceeds one chip's HBM.
    """
    from .._methods.gls import _gls_bucket_kernel, build_face_pack

    node_sh = node_sharding(mesh, axis)
    rep = replicated(mesh)
    geo_sh = node_sharding(mesh, axis) if shard_geometry else rep
    n_dev = mesh.devices.size

    def _put_geo(arr):
        """Shard a geometry array on dim 0, padding it to the mesh size
        (padded entries are never indexed: all stencil ids stay below the
        original extent)."""
        if not shard_geometry:
            return jax.device_put(arr, rep)
        arr = np.asarray(arr)
        n0 = arr.shape[0]
        pad = (-n0) % n_dev
        if pad:
            widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
            arr = np.pad(arr, widths)
        return jax.device_put(arr, geo_sh)

    def run(bucket, perm, diff_mag, neumann_flag, neumann_val,
            n_refine=3, exact=False, neumann_compat=True,
            with_neumann=True):
        put = _put_geo
        # the ONE packed face row construction site
        # (gls.build_face_pack) — built on dgrid's device, fetched and
        # re-placed under this function's mesh/padding policy
        face_pack = np.asarray(build_face_pack(
            dgrid, np.asarray(perm), np.asarray(diff_mag),
            np.asarray(neumann_val), put_geo=jnp.asarray))

        args = (
            jax.device_put(bucket["nodes"], node_sh),
            jax.device_put(bucket["valid"], node_sh),
            put(dgrid.esup2d), put(dgrid.esup_cnt),
            put(dgrid.fsup2d), put(dgrid.fsup_cnt),
            put(np.asarray(dgrid.point_pack)),
            put(np.asarray(dgrid.cell_pack)),
            put(np.asarray(dgrid.face_ipack)), put(face_pack),
            put(np.asarray(neumann_flag)),
        )
        with mesh:
            return _gls_bucket_kernel(
                *args, E=bucket["E"], F=bucket["F"], n_refine=n_refine,
                exact=exact, neumann_compat=neumann_compat,
                with_neumann=with_neumann)

    return run
