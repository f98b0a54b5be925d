"""Headline benchmark: GLS node weights on a ~1.9M-cell tet mesh.

Prints ONE JSON line:
  {"metric": ..., "value": <Mnodes/s>, "unit": "Mnodes/s",
   "vs_baseline": <ratio vs the Cython reference>, "device": {...}, ...}

The record names the device it ran on (JAX platform, device_kind and
count; on a GPU host also the card name and power limit from
nvidia-smi).  Only a run on the GPU gives a device number: a CPU run
checks the contract and accuracy, not speed.

Reference baseline (BASELINE.md): Cython GLS on tetra meshes runs at
309,293 points / 14.325 s = 0.0216 Mnodes/s (mesh-size independent for the
structured tet family; <=16 OpenMP threads).  vs_baseline is our measured
throughput divided by that.

Accuracy companion numbers (also printed on stderr and embedded in the
JSON as extra keys): max relative error of the delivered weights vs the
scipy dgels oracle (the reference's own LAPACK driver) on a node
subsample, plus grid build time.

Scale knobs via env: NINPOL_BENCH_N (default 68 -> 6*68^3 = 1,886,592
cells, 328,509 points — the scale of the reference's own largest tetra
benchmark row, performance.yaml: 1,950,720 cells / 309,293 points).
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_MNODES_S = 309293 / 14.325 / 1e6   # Cython tetra GLS throughput


def card_info():
    """``name, power.limit`` of each GPU as nvidia-smi reports them
    (a child process that stays off JAX), or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def device_record():
    """What the numbers were measured on, as JAX and nvidia-smi see it."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_info(),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def build_problem(n, **interp_kwargs):
    """~6n^3-cell tet mesh with an ALH-style varying full-tensor K and a
    seeded Dirichlet/Neumann boundary split (no sympy: flux evaluated from
    the closed-form gradient of u = x^2 + y^2 + z^2).  ``interp_kwargs``
    go to the Interpolator (e.g. ``mesh=4``)."""
    import ninpol_tpu
    from ninpol_tpu.utils import meshgen

    mesh = meshgen.tetra_mesh(n)
    pts = mesh.points
    cells = mesh.cells[0].data
    cents = pts[cells].mean(axis=1)
    x, y, z = cents[:, 0], cents[:, 1], cents[:, 2]
    K = np.zeros((len(cells), 3, 3))
    K[:, 0, 0] = y * y + z * z + 1
    K[:, 0, 1] = K[:, 1, 0] = -x * y
    K[:, 0, 2] = K[:, 2, 0] = -x * z
    K[:, 1, 1] = x * x + z * z + 1
    K[:, 1, 2] = K[:, 2, 1] = -y * z
    K[:, 2, 2] = x * x + y * y + 1
    sol = x ** 2 + y ** 2 + z ** 2

    interp = ninpol_tpu.Interpolator(**interp_kwargs)
    mesh.cell_data = {"permeability": [K.reshape(-1, 9)], "u": [sol]}
    mesh.point_data = {}
    t0 = time.perf_counter()
    interp.load_mesh(mesh_obj=mesh)
    build_time = time.perf_counter() - t0
    grid = interp.grid

    # boundary split (seeded), Neumann flux g = -(K grad u).n with
    # grad u = 2*(x,y,z) evaluated at boundary-face centers
    rng = np.random.default_rng(0)
    boundary = np.nonzero(grid.boundary_faces)[0]
    ridx = rng.choice(len(boundary), len(boundary) // 2, replace=False)
    neumann_faces = np.setdiff1d(boundary, boundary[ridx])

    pv = np.zeros(grid.n_points)
    dpts = grid.inpofa[boundary[ridx]].ravel()
    np.add.at(pv, dpts[dpts != -1], 1)
    npts = grid.inpofa[neumann_faces].ravel()
    np.add.at(pv, npts[npts != -1], -1)
    bpts = np.nonzero(grid.boundary_points)[0]
    neumann_points = bpts[pv[bpts] < 0]

    owners = grid.esuf[grid.esuf_ptr[boundary]]
    fc = grid.faces_centers[boundary]
    gradu = 2 * fc
    flux = -np.einsum("fij,fj->fi", K[owners], gradu)
    nval_faces = np.zeros(grid.n_faces)
    nval_faces[boundary] = np.einsum(
        "fi,fi->f", flux, grid.normal_faces[boundary])

    counts = np.diff(grid.fsup_ptr)
    owner_pt = np.repeat(np.arange(grid.n_points), counts)
    sums = np.bincount(owner_pt, weights=nval_faces[grid.fsup],
                       minlength=grid.n_points)
    neumann = np.zeros(grid.n_points)
    neumann[neumann_points] = (sums / np.maximum(counts, 1))[neumann_points]
    nflag = np.zeros(grid.n_points)
    nflag[neumann_points] = 1

    interp.load_data({
        "neumann_u": neumann, "neumann_flag_u": nflag,
        "dirichlet_flag_u": 1 - nflag,
    }, "points")
    return interp, build_time


def main():
    import jax

    n = int(os.environ.get("NINPOL_BENCH_N", "68"))
    t_all = time.perf_counter()
    interp, build_time = build_problem(n)
    # refinement sweep count (sweeps = n_refine + 1)
    interp.gls.n_refine = int(os.environ.get("NINPOL_BENCH_REFINE", "2"))
    grid = interp.grid
    n_points = grid.n_points
    n_cells = grid.n_elems
    device = device_record()
    print(f"# device: {device}", file=sys.stderr)
    print(f"# mesh: {n_cells} cells, {n_points} points; "
          f"grid build {build_time:.2f}s", file=sys.stderr)

    tp = np.arange(n_points)
    # warmup (compiles + device-grid upload); report how much came from
    # the persistent compile cache vs fresh compiles
    cache_dir = jax.config.jax_compilation_cache_dir

    def cache_entries():
        try:
            return len(os.listdir(cache_dir))
        except (OSError, TypeError):
            return 0
    n_before = cache_entries()
    t0 = time.perf_counter()
    interp.prepare_interpolator("gls", "u", tp)
    warm = time.perf_counter() - t0
    n_new = cache_entries() - n_before
    n_progs = interp.gls.last_program_count
    print(f"# warmup: {warm:.2f}s ({n_new} fresh compiles, "
          f"{n_before} cached executables available"
          f"{' — fully warm' if n_new == 0 else ''}; "
          f"plan executables: {n_progs})", file=sys.stderr)

    # host-complete (the reference contract: weights in host memory)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        W, NW = interp.prepare_interpolator("gls", "u", tp)
        times.append(time.perf_counter() - t0)
    t_gls = min(times)
    mnodes = n_points / t_gls / 1e6
    print(f"# GLS weights (host-complete): {t_gls:.3f}s -> "
          f"{mnodes:.3f} Mnodes/s (runs: {[round(t, 3) for t in times]})",
          file=sys.stderr)

    # device-complete: weights resident on the device (the natural
    # product for an on-device MPFA consumer)
    dtimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        wdev = interp.prepare_interpolator("gls", "u", tp, device_out=True)
        wdev.block_until_ready()
        dtimes.append(time.perf_counter() - t0)
    t_dev = min(dtimes)
    dev_mnodes = n_points / t_dev / 1e6
    t0 = time.perf_counter()
    host_copy = np.asarray(wdev)
    t_fetch = time.perf_counter() - t0
    mb = host_copy.nbytes / 1e6
    print(f"# GLS weights (device-complete): {t_dev:.3f}s -> "
          f"{dev_mnodes:.3f} Mnodes/s (runs: "
          f"{[round(t, 3) for t in dtimes]})", file=sys.stderr)
    print(f"# device->host delivery: {mb:.0f} MB in {t_fetch:.3f}s "
          f"({mb / max(t_fetch, 1e-9):.0f} MB/s)", file=sys.stderr)

    # accuracy: the delivered weights vs the scipy-dgels ORACLE (the
    # reference's own LAPACK driver) on a node subsample, computed on
    # the host
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests"))
    from utils.oracle import gls_oracle
    rng = np.random.default_rng(1)
    interior = np.nonzero(~grid.boundary_points.astype(bool))[0]
    sub = rng.choice(interior, min(4096, len(interior)), replace=False)
    v2i = interp.variable_to_index
    t0 = time.perf_counter()
    Wo, _, cond = gls_oracle(
        grid, sub,
        interp.cells_data[v2i["cells"]["permeability"]],
        interp.cells_data[v2i["cells"]["diff_mag"]],
        interp.points_data[v2i["points"]["neumann_flag_u"]].astype(int),
        interp.points_data[v2i["points"]["neumann_u"]],
        return_cond=True)
    ok = cond < 1e7
    scale = max(np.abs(Wo).max(), 1.0)
    ncols = min(W.shape[1], Wo.shape[1])
    max_rel_err = float(
        np.abs(W[sub][ok][:, :ncols] - Wo[ok][:, :ncols]).max() / scale)
    print(f"# max rel err (delivered weights vs scipy dgels oracle, "
          f"{int(ok.sum())}/{len(sub)} nodes, cond<1e7; oracle host time "
          f"{time.perf_counter() - t0:.1f}s): {max_rel_err:.3e}",
          file=sys.stderr)

    # full end-to-end CSR (info)
    t0 = time.perf_counter()
    W, NW = interp.interpolate("u", "gls")
    t_csr = time.perf_counter() - t0
    print(f"# end-to-end interpolate (kernel + CSR assembly): {t_csr:.3f}s; "
          f"nnz={W.nnz}", file=sys.stderr)
    print(f"# total bench wall time: {time.perf_counter() - t_all:.1f}s",
          file=sys.stderr)

    result = {
        "metric": (f"GLS node-weights throughput, {n_cells}-cell tet mesh, "
                   f"one {device['kind']} ({device['platform']}), "
                   "host-complete (device-complete in device_mnodes_s; "
                   "max rel err vs the dgels oracle in max_rel_err)"),
        "value": round(mnodes, 4),
        "unit": "Mnodes/s",
        "vs_baseline": round(mnodes / BASELINE_MNODES_S, 2),
        "device": device,
        "max_rel_err": max_rel_err,
        "grid_build_s": round(build_time, 3),
        "gls_time_s": round(t_gls, 4),
        "device_mnodes_s": round(dev_mnodes, 4),
        "device_vs_baseline": round(dev_mnodes / BASELINE_MNODES_S, 2),
        "d2h_s": round(t_fetch, 3),
        "d2h_mb_s": round(mb / max(t_fetch, 1e-9), 1),
        "n_cells": int(n_cells),
        "n_points": int(n_points),
        "n_bad": interp.gls.last_n_bad,
        "warmup_s": round(warm, 1),
        "fresh_compiles": int(n_new),
        "plan_programs": n_progs,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
