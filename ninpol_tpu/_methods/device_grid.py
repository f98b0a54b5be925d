"""Device-resident padded grid arrays + stencil bucketing.

The reference walks ragged CSR adjacency per node inside OpenMP loops
(e.g. gls.pyx:161-219).  Under jit every shape must be static, so the grid's
CSR structures are converted once into padded 2D device arrays, and target
nodes are *bucketed* by stencil size (n_elem, n_face) so each bucket
jit-compiles one fixed-shape kernel (SURVEY.md §7 "shape manager").
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .._grid.topology import csr_to_padded


def _round_up(x, m):
    return int(-(-int(x) // m) * m)


# Canonical stencil-size ladder shared by ALL meshes: every bucket's
# static (E, F) snaps UP to a ladder value, so different meshes of the
# same family hit the SAME compiled kernel shapes (free-form quantile
# cuts gave each mesh its own shapes, and compile time grows with the
# shape count).
_SIZE_LADDER = (4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 48, 56, 64, 80, 96,
                112, 128, 160, 192, 224, 256)


def _ladder_up(x):
    x = int(x)
    for v in _SIZE_LADDER:
        if v >= x:
            return v
    return _round_up(x, 64)


def _pow2_down(x, lo):
    b = int(lo)
    while b * 2 <= x:
        b *= 2
    return b


class DeviceGrid:
    """Padded device mirrors of the Grid structures used by the methods.

    With ``mesh`` (a jax.sharding.Mesh), every array is REPLICATED over
    the mesh's devices and the method drivers route kernels through
    jax.shard_map with the node batch sharded over the mesh axis — the
    multi-chip scaling path (per-node weights are node-local, so stencil
    gathers stay device-local and no collectives are needed; see
    parallel/sharding.py for the geometry-sharded memory-scaling
    variant)."""

    def __init__(self, grid, mesh=None, shard_geometry=False):
        self.grid = grid
        self.mesh = mesh
        self.shard_geometry = bool(shard_geometry) and mesh is not None
        self.dim = grid.dim
        self.n_points = grid.n_points
        self.n_elems = grid.n_elems
        self.n_faces = grid.n_faces

        # Host padded adjacency (int32: indices < 2^31).  Widths are
        # rounded up to the same granularity the bucket classes use so a
        # bucket's static E/F never exceeds the array width.
        self.esup2d_h = csr_to_padded(
            grid.esup_ptr, grid.esup,
            _ladder_up(max(grid.MX_ELEMENTS_PER_POINT, 1))
        ).astype(np.int32)
        self.esup_cnt_h = np.diff(grid.esup_ptr).astype(np.int32)
        self.fsup2d_h = csr_to_padded(
            grid.fsup_ptr, grid.fsup,
            _ladder_up(max(grid.MX_FACES_PER_POINT, 1))
        ).astype(np.int32)
        self.fsup_cnt_h = np.diff(grid.fsup_ptr).astype(np.int32)
        esuf_w = max(grid.MX_ELEMENTS_PER_FACE, 2)
        self.esuf2d_h = csr_to_padded(
            grid.esuf_ptr, grid.esuf, esuf_w).astype(np.int32)

        if mesh is None:
            target = jax.devices()[0]
        else:
            from jax.sharding import NamedSharding, PartitionSpec
            target = NamedSharding(mesh, PartitionSpec())
        put = lambda x: jax.device_put(jnp.asarray(x), target)

        if self.shard_geometry:
            # HBM-scaling mode: partition every per-entity grid array
            # over the mesh (dim 0, zero-padded to the mesh size —
            # padded entries are never gathered: all stencil ids stay
            # below the original extents).  Kernels then run under GSPMD
            # auto-partitioning (gls/idw/ls drivers skip shard_map) and
            # XLA inserts the all-gathers for the stencil gathers.
            axis = mesh.axis_names[0]
            geo_target = NamedSharding(mesh, PartitionSpec(axis))
            n_dev = mesh.devices.size

            def put(arr):  # noqa: F811 - intentional mode override
                arr = np.asarray(arr)
                pad = (-arr.shape[0]) % n_dev
                if pad:
                    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
                    arr = np.pad(arr, widths)
                return jax.device_put(jnp.asarray(arr), geo_target)
        # per-variable data (GLS face_pack / neumann flags) follows the
        # same placement as the grid arrays
        self.put_geo = put

        def hpack(a):
            """hi/lo float32 split of a float64 array, packed host-side
            into one (n, 2k) row (hi + lo reconstructs f64 bit-exactly).
            Building packs on the HOST and uploading once avoids both a
            per-pack device concat program and a duplicate pair copy in
            device memory."""
            a = np.asarray(a, np.float64)
            h = a.astype(np.float32)
            return np.concatenate(
                [h, (a - h.astype(np.float64)).astype(np.float32)],
                axis=1)

        def put_pair(a):
            """Device-resident hi/lo float32 pair of a float64 geometry
            array (consumed by the per-variable GLS face_pack concat)."""
            p = hpack(a)
            k = p.shape[1] // 2
            return put(p[:, :k]), put(p[:, k:])

        self.nrm_h, self.nrm_l = put_pair(grid.normal_faces)
        self.fcc_h, self.fcc_l = put_pair(grid.faces_centers)
        self._f64_cache = {}
        self._plan_cache = {}
        # PACKED gather tables: per-point/per-cell/per-face data is
        # packed into one wide row per entity and gathered ONCE, instead
        # of one narrow gather per array.
        self.point_pack = put(hpack(grid.point_coords))
        self.cell_pack = put(hpack(grid.centroids))
        # int face row: the esuf pair only (boundary flag = esuf[1] < 0;
        # inpofa stays host-side — the per-face Neumann mean that used
        # to need it on device is precomputed on the host, gls.py).
        # Keeping it to 2 columns saves ~75 MB of upload at 2M-cell
        # scale.  Ids live only in int32 tables: stored as float32 bit
        # patterns, ids below 2^23 are subnormal floats, and a gather
        # partitioned over devices (a masked local gather plus a sum
        # across them) flushes those to zero on the GPU.
        self.face_ipack = put(self.esuf2d_h[:, :2])
        self.esup2d = put(self.esup2d_h)
        self.esup_cnt = put(self.esup_cnt_h)
        self.fsup2d = put(self.fsup2d_h)
        self.fsup_cnt = put(self.fsup_cnt_h)
        # esuf2d/inpofa/boundary flags live only inside face_ipack (and
        # as host arrays on the Grid) — no separate device copies.

    # float64 device views reconstructed lazily from the pairs/packs
    # (exact: hi + lo is the original value) — convenience accessors;
    # the method kernels read the packs directly.
    def _f64(self, name, h, l):
        if name not in self._f64_cache:
            self._f64_cache[name] = (h.astype(jnp.float64)
                                     + l.astype(jnp.float64))
        return self._f64_cache[name]

    @property
    def point_coords(self):
        return self._f64("pc", self.point_pack[:, 0:3],
                         self.point_pack[:, 3:6])

    @property
    def centroids(self):
        return self._f64("cen", self.cell_pack[:, 0:3],
                         self.cell_pack[:, 3:6])

    @property
    def normal_faces(self):
        return self._f64("nrm", self.nrm_h, self.nrm_l)

    @property
    def faces_centers(self):
        return self._f64("fcc", self.fcc_h, self.fcc_l)

    # ------------------------------------------------------------------
    def buckets(self, target_points, active_mask, need_faces=True,
                max_buckets=3, min_bucket=2048, batch_align=256,
                chunk_size=8192, chunk_elems=None):
        """Split (positions into target_points) of *active* nodes into
        fixed-shape work chunks.

        Returns a list of dicts with:
          pos      positions into the target array (np.int64, padded with -1)
          nodes    global node ids (np.int32, padded with 0, masked inactive)
          valid    mask of real entries
          E, F     static per-bucket stencil paddings (multiples of 4)

        Nodes are first classed into stencil-size buckets (quantile cuts
        on n_elem, snapped UP to the canonical _SIZE_LADDER so all
        meshes share the same compiled shapes), then each bucket is
        sliced into power-of-two chunks of at most ``chunk_size`` nodes
        so kernel working memory stays bounded (a full 1M-cell mesh in
        one batch would exceed HBM).  All full chunks share one compiled
        shape; tails pad to the next power of two.
        """
        target_points = np.asarray(target_points)
        # Content-keyed plan cache: repeat prepares over the same target
        # set (bench repeats; different variables on one mesh) reuse the
        # plan AND its device-resident nodes/valid arrays — zero
        # host->device uploads on a hit.  NOTE: callers may stamp extra metadata
        # (e.g. with_neumann) onto the returned dicts; for identical
        # inputs those stamps are identical, so sharing is safe.
        import hashlib
        ck = (hashlib.sha1(target_points.tobytes()).hexdigest(),
              hashlib.sha1(np.ascontiguousarray(
                  active_mask).tobytes()).hexdigest(),
              need_faces, max_buckets, min_bucket, batch_align,
              chunk_size, chunk_elems)
        hit = self._plan_cache.get(ck)
        if hit is not None:
            return hit
        pos_all = np.nonzero(active_mask)[0]
        if len(pos_all) == 0:
            if len(self._plan_cache) >= 8:
                self._plan_cache.pop(next(iter(self._plan_cache)))
            self._plan_cache[ck] = []
            return []
        nodes_all = target_points[pos_all]
        ne = self.esup_cnt_h[nodes_all].astype(np.int64)
        nf = (self.fsup_cnt_h[nodes_all].astype(np.int64)
              if need_faces else np.zeros_like(ne))

        # batch sizes are batch_align * 2^k (multichip passes
        # 128 * n_devices so every chunk shards evenly over the devices)
        batch_align = max(int(batch_align), 256)
        qs = [0.5, 0.85, 1.0][-max_buckets:]
        cuts = sorted({_ladder_up(np.quantile(ne, q)) for q in qs})
        assigned = np.full(len(pos_all), -1)
        for ci, cut in enumerate(cuts):
            sel = (assigned < 0) & (ne <= cut)
            assigned[sel] = ci

        out = []
        carry = np.zeros(len(pos_all), dtype=bool)
        for ci, cut in enumerate(cuts):
            sel = (assigned == ci) | carry
            if ci + 1 < len(cuts) and sel.sum() < min_bucket:
                carry = sel
                continue
            carry = np.zeros(len(pos_all), dtype=bool)
            if not sel.any():
                continue
            E = _ladder_up(ne[sel].max())
            F = _ladder_up(nf[sel].max()) if need_faces else 0
            p = pos_all[sel]
            nsel = nodes_all[sel]
            csize = _pow2_down(chunk_size, batch_align)
            if chunk_elems is not None:
                # bound kernel working set: B * m * n matrix elements
                m_pad = 4 * E + 4 * F
                n_pad = 3 * E + 1
                csize = max(batch_align, min(
                    csize,
                    _pow2_down(max(chunk_elems // (m_pad * n_pad), 1),
                               batch_align)))
            # Full chunks share one compiled shape.  The tail becomes
            # quantum chunks of csize/4 plus ONE final chunk snapped UP
            # to the geometric ladder csize/4^k (floored at
            # batch_align), so a bucket class touches at most THREE
            # distinct (E, F, B) programs per run (each distinct
            # program is one more compile and load), while the final
            # chunk pads by at most 4x its real nodes — a single fixed
            # quantum instead padded tiny CPU-test meshes 27 -> 8192
            # nodes (70 s/call, suite-breaking).
            n_full = len(p) // csize
            q = max(batch_align, csize // 4)
            if n_full % 2 == 1 and csize > q:
                # keep the full-chunk count EVEN: even counts decompose
                # exactly over the {16,8,4,2} scan ladder, so the big-B
                # stacks never need dummy-chunk padding (a dummy full
                # chunk costs a full chunk of device compute per run);
                # the demoted chunk's nodes flow into the
                # quantum class, whose chunks are 4x cheaper to pad
                n_full -= 1
            plan = [(csize, csize)] * n_full
            rem = len(p) - n_full * csize
            while rem >= q:
                plan.append((q, q))
                rem -= q
            if rem > 0:
                if plan:
                    # the mesh already fills >= one chunk: snap the final
                    # partial chunk UP to the quantum so it shares the
                    # quantum class's compiled program (and its scan
                    # stacks) — <= q-1 padded nodes instead of one more
                    # distinct (E, F, B) program
                    plan.append((q, rem))
                else:
                    # tiny mesh (CPU tests): geometric ladder keeps the
                    # padding <= 4x the real nodes
                    last = q
                    while last // 4 >= max(batch_align, rem):
                        last //= 4
                    plan.append((max(batch_align, last), rem))
            lo = 0
            for B, take in plan:
                pc = p[lo:lo + take]
                nc = nsel[lo:lo + take]
                pos = np.full(B, -1, dtype=np.int64)
                pos[:take] = pc
                nodes = np.zeros(B, dtype=np.int32)
                nodes[:take] = nc
                out.append({"pos": pos, "nodes": nodes, "E": E, "F": F,
                            "valid": pos >= 0})
                lo += take
        if len(self._plan_cache) >= 8:
            self._plan_cache.pop(next(iter(self._plan_cache)))
        self._plan_cache[ck] = out
        return out


def bucket_dev(b):
    """Device-resident (nodes, valid) for a bucket, created lazily and
    cached on the bucket dict (which rides the content-keyed plan cache,
    so repeat prepares re-use the device arrays).  Lazy because
    scan-stacked chunk groups (methods/gls.py) consume their own stacked
    uploads and never touch the per-chunk arrays."""
    if "nodes_d" not in b:
        b["nodes_d"] = jnp.asarray(b["nodes"])
        b["valid_d"] = jnp.asarray(b["valid"])
    return b["nodes_d"], b["valid_d"]


from functools import partial as _partial


def _pad_cols_j(w, ncols_out, extra=0):
    ncols = min(w.shape[1], ncols_out)
    return jnp.concatenate(
        [w[:, :ncols],
         jnp.zeros((w.shape[0], ncols_out - ncols + extra), w.dtype)],
        axis=1)


@_partial(jax.jit, static_argnames=("n_target", "ncols_out"))
def _deliver_device_j(rows_list, pos_flat, *, n_target, ncols_out):
    """One program: pad + scatter all bucket rows into the consolidated
    [weights | 0] array instead of eager per-bucket pad/concat/scatter
    ops, each its own executable.  pos_flat carries ALL buckets'
    positions in one array (one upload, not one transfer per bucket);
    slices are static."""
    wdev = jnp.zeros((n_target, ncols_out + 1), jnp.float64)
    off = 0
    for w in rows_list:
        pos = pos_flat[off:off + w.shape[0]]
        off += w.shape[0]
        wdev = wdev.at[pos].set(_pad_cols_j(w, ncols_out, extra=1),
                                mode="drop")
    return wdev


@_partial(jax.jit, static_argnames=("delivery_f32", "ncols_out"))
def _deliver_concat_j(rows_list, *, delivery_f32, ncols_out):
    rows = [_pad_cols_j(w, ncols_out) for w in rows_list]
    cat = rows[0] if len(rows) == 1 else jnp.concatenate(rows, axis=0)
    return cat.astype(jnp.float32) if delivery_f32 else cat


def group_plan(items):
    """Fetch-group composition for host delivery (shared by the real
    fetch loops and the shape-only executable preloads)."""
    if not items:
        return []
    n_groups = min(4, len(items))
    per = -(-len(items) // n_groups)
    return [items[i:i + per] for i in range(0, len(items), per)]


def fetch_groups_overlapped(cats, groups, write_group):
    """Fetch group k+1's device->host transfer on a helper thread (the
    fetch waits on the device and releases the GIL) while the main
    thread runs ``write_group(groups[k], host_k)`` — the host row
    scatter would otherwise serialize after the last fetch.  Exactly
    one fetch is in flight at a time."""
    if not groups:
        return
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=1) as tpe:
        fut = tpe.submit(np.asarray, cats[0])
        for gi, grp in enumerate(groups):
            host = fut.result()
            if gi + 1 < len(groups):
                fut = tpe.submit(np.asarray, cats[gi + 1])
            write_group(grp, host)


# Shape signatures whose executables this process already loaded — the
# dummy preload executions are pure load-warming, so repeat prepares
# skip them (they cost a dropped full-size consolidation execution plus
# transient result-scale device memory).
_preloaded_sigs = set()


# Scan-stack sizes snap to this ladder (largest first) so scan programs
# come from a small fixed set of shapes — every distinct program is one
# more compile and load.
_SCAN_LADDER = (16, 8, 4, 2)


def _dummy_chunk(proto):
    """An all-invalid chunk of the same (E, F, B) class as ``proto`` —
    scan stacks pad with these to land on a ladder size (pos -1 routes
    every output row out of bounds; valid=False keeps kernels inert)."""
    B = len(proto["pos"])
    return {"pos": np.full(B, -1, dtype=np.int64),
            "nodes": np.zeros(B, dtype=np.int32),
            "valid": np.zeros(B, dtype=bool),
            "E": proto["E"], "F": proto.get("F", 0)}


def build_scan_units(all_buckets, extra_keys=()):
    """Group identical-shape chunks into lax.scan stacks.  Returns a
    list of ("scan", megabucket) / ("single", bucket) units.  Megabuckets
    carry concatenated host pos/valid (for delivery + fallback masks)
    and the stacked device inputs, cached on the first member's dict so
    repeat prepares over the same cached plan re-use the uploads.

    Groups SNAP UP to the ladder with all-invalid dummy chunks when the
    padding is cheap (dummy work capped at 12288 padded nodes): a
    distinct program shape is one more compile and load, so lone small
    chunks ride an S=2 stack rather than keeping a single-dispatch
    program alive — but a dummy FULL chunk would cost a full chunk of
    compute on every run, so big-B odd tails stay singles (the chunk
    planner keeps full-chunk counts even precisely to avoid that).
    ``extra_keys`` join the class key (and are stamped onto the
    megabucket), e.g. GLS's with_neumann."""
    from collections import defaultdict
    by_cls = defaultdict(list)
    for b in all_buckets:
        key = (b["E"], b.get("F", 0), len(b["pos"]),
               tuple(b.get(k) for k in extra_keys))
        by_cls[key].append(b)
    units = []
    for (E, F, B, _xk), bs in by_cls.items():
        i = 0
        while i < len(bs):
            r = len(bs) - i
            s_up = next((s for s in reversed(_SCAN_LADDER) if s >= r),
                        None)
            if s_up is not None and (s_up - r) * B <= 12288:
                S = s_up
            elif r >= _SCAN_LADDER[-1]:
                S = next(s for s in _SCAN_LADDER if s <= r)
            else:
                units.append(("single", bs[i]))
                i += 1
                continue
            grp = list(bs[i:i + min(S, r)])
            i += min(S, r)
            proto = grp[0]
            mb = proto.get("_scan_unit")
            if mb is None or mb["S"] != S:
                full = grp + [_dummy_chunk(proto)
                              for _ in range(S - len(grp))]
                mb = {
                    "pos": np.concatenate([b["pos"] for b in full]),
                    "valid": np.concatenate([b["valid"] for b in full]),
                    "E": E, "F": F, "S": S,
                    "nodes_sd": jnp.asarray(
                        np.stack([b["nodes"] for b in full])),
                    "valid_sd": jnp.asarray(
                        np.stack([b["valid"] for b in full])),
                }
                proto["_scan_unit"] = mb
            for k in extra_keys:
                mb[k] = proto.get(k)
            units.append(("scan", mb))
    return units


def dispatch_units_with_preload(units, run_unit, n_target, ncols_out,
                                device_out, delivery_f32):
    """Dispatch ``run_unit(unit)`` for every ("scan"/"single", payload)
    unit, first loading each DISTINCT compiled program from a thread
    pool: an executable load or compile blocks the dispatching thread,
    and loads overlap across threads.  The solve programs
    preload by RUNNING the first unit of each shape class (results kept
    — no work runs twice); the delivery consolidation preloads with
    same-shape device-resident zero inputs (junk results dropped;
    jnp.zeros allocates on device), once per shape signature per
    process.  Returns [(payload, rows)]."""
    def usig(u):
        kind, p = u
        return (kind, p["E"], p.get("F", 0), p.get("S", 1),
                len(p["pos"]))

    import os
    gd = os.environ.get("NINPOL_TPU_GROUP_DELIVERY") == "1"
    preloaded = {}
    payloads = [u[1] for u in units]
    if units:
        first_of = {}
        for u in units:
            first_of.setdefault(usig(u), u)
        # program identity depends on the FULL unit shape sequence
        # (group composition), not just the distinct classes
        sig = ("deliver", tuple((p["E"], len(p["pos"])) for p in payloads),
               n_target, ncols_out, device_out, bool(delivery_f32), gd)

        def dummy_rows(ps):
            return tuple(jnp.zeros((len(p["pos"]), p["E"]), jnp.float64)
                         for p in ps)

        def preload_delivery():
            if device_out or not gd:
                pos = jnp.zeros((sum(len(p["pos"]) for p in payloads),),
                                jnp.int64)
                _deliver_device_j(dummy_rows(payloads), pos,
                                  n_target=n_target, ncols_out=ncols_out)
            else:
                for grp in group_plan(payloads):
                    _deliver_concat_j(dummy_rows(grp),
                                      delivery_f32=bool(delivery_f32),
                                      ncols_out=ncols_out)

        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(8, len(first_of) + 1)) as ex:
            futs = {ex.submit(run_unit, u): id(u[1])
                    for u in first_of.values()}
            job = None
            if sig not in _preloaded_sigs:
                _preloaded_sigs.add(sig)
                job = ex.submit(preload_delivery)
            for f in futs:
                preloaded[futs[f]] = f.result()
            if job is not None:
                job.result()
    out = []
    for kind, p in units:
        w = preloaded.pop(id(p), None)
        out.append((p, w if w is not None else run_unit((kind, p))))
    return out


def plan_pos_flat(payloads, n_target):
    """Device-resident concatenation of a plan's padded positions
    (pos < 0 routed to n_target so scatters drop them), CACHED on the
    plan's first payload dict.  Payload dicts persist in the DeviceGrid
    plan cache / scan-unit cache, so repeat prepares skip the
    re-upload — pos_flat is n_target int64s, ~17 MB at 2.1M points,
    and it sits INSIDE the timed device-complete path."""
    first = payloads[0]
    key = (int(n_target), tuple(len(p["pos"]) for p in payloads))
    cache = first.setdefault("_pos_flat", {})
    pf = cache.get(key)
    if pf is None:
        pf = jnp.asarray(np.concatenate(
            [np.where(p["pos"] >= 0, p["pos"], n_target)
             for p in payloads]))
        cache[key] = pf
    return pf


def deliver_weights(launched, weights, neumann_ws, n_target, device_out,
                    delivery_f32=False):
    """Shared IDW/LS result delivery.

    launched: [(bucket, (B, ncols) device rows)].
    device_out=True returns a consolidated (n_target, ncols+1) float64
    device array [weights | 0] (the neumann column is zero — IDW/LS
    never write it, idw.pyx/ls.pyx) for on-device consumers, skipping
    the host transfer entirely.  delivery_f32=True fetches the rows as
    float32 (half the bytes; ~1e-7 relative rounding — documented
    non-parity knob).  Bucket rows may be narrower than the output:
    padding happens inside the jitted consolidation."""
    ncols_out = weights.shape[1]
    if device_out:
        if not launched:
            return jnp.zeros((n_target, ncols_out + 1), jnp.float64)
        pos_flat = plan_pos_flat([b for b, _ in launched], n_target)
        return _deliver_device_j(tuple(w for _, w in launched),
                                 pos_flat, n_target=n_target,
                                 ncols_out=ncols_out)
    if not launched:
        return weights, neumann_ws
    import os
    if os.environ.get("NINPOL_TPU_GROUP_DELIVERY") != "1":
        # Host delivery rides the SAME consolidation program as
        # device_out (one fewer distinct executable) and fetches in ONE
        # transfer; values are bit-identical to the grouped path (same
        # rows, same at[pos].set scatter the device_out tests pin).
        pos_flat = plan_pos_flat([b for b, _ in launched], n_target)
        wdev = _deliver_device_j(tuple(w for _, w in launched),
                                 pos_flat, n_target=n_target,
                                 ncols_out=ncols_out)
        src = wdev.astype(jnp.float32) if delivery_f32 else wdev
        host = np.asarray(src)
        rows = np.concatenate(
            [b["pos"][b["valid"]] for b, _ in launched])
        weights[rows, :] = host[rows, :ncols_out]
        return weights, neumann_ws
    # Legacy grouped host delivery (NINPOL_TPU_GROUP_DELIVERY=1): a few
    # compact fetch groups; group k+1's transfer runs on a helper thread
    # while the main thread scatters group k's rows into `weights`.
    groups = group_plan(launched)
    cats = [_deliver_concat_j(tuple(w for _, w in grp),
                              delivery_f32=bool(delivery_f32),
                              ncols_out=ncols_out) for grp in groups]

    def write_group(grp, host):
        lo = 0
        for bucket, w in grp:
            nb = w.shape[0]
            sel = bucket["valid"]
            pos = bucket["pos"][sel]
            weights[pos, :] = host[lo:lo + nb][sel]
            lo += nb

    fetch_groups_overlapped(cats, groups, write_group)
    return weights, neumann_ws
