"""Start-up proof on the GPU: drive ninpol_tpu's main path once at full
size through the public API and check every result.

    python chip_smoke.py                # one GPU, every phase below
    python chip_smoke.py --devices 4    # four GPUs: the multi-device path only

One GPU, in one process, in this order:

  device      fail unless JAX's first device is a GPU; print device_kind,
              count, the card's name and power limit (nvidia-smi),
              XLA_FLAGS, the compile-cache directory, x64 and the default
              matmul precision
  precision   the batched Gram helper at the real GLS widths (B=1024,
              m=132, n=73) vs NumPy float64: max rel err <= 1e-5, which
              TF32 (~1e-4) would fail
  gls         Interpolator.interpolate("u", "gls") on meshgen.tetra_mesh(68)
              (1,886,592 cells, 328,509 points; bench.build_problem):
              finite CSR, interior row sums 1, prepare_interpolator vs the
              dgels oracle on 1,024 seeded interior + Neumann nodes
              (<= 1e-10, cond >= 1e7 masked); prints the exact-path count
              and fails when it exceeds 1% of the solved nodes
  exact       gls.exact = True on 4,096 seeded nodes vs the oracle (<= 1e-10)
  idw / ls    interpolate() vs idw_oracle (<= 1e-12) and ls_oracle
              (<= 1e-11, degenerate denominators masked) on 4,096 nodes
  device_out  prepare_interpolator(device_out=True) lives on the GPU and
              equals the host-delivered weights bit for bit

With --devices N, only the N-device path: the same problem through
Interpolator(mesh=N) and Interpolator(mesh=N, shard_geometry=True), gls,
idw and ls on both, each compared with a one-device run in the same
process (<= 1e-12 relative) and with the oracle subsample (<= 1e-10),
GLS's exact-path count held to 1% as above.  Each configuration prints
the bytes of the grid tables on every device and checks that they are
replicated (mesh=N) or split N ways (shard_geometry).

After every phase one info line gives its wall time (after
block_until_ready), each device's peak_bytes_in_use and the card.  Any
failure prints a traceback and exits non-zero; the last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import argparse
import json
import os
import sys
import time
import traceback

# The oracles run one small LAPACK call per node, which a multithreaded
# BLAS slows down by an order of magnitude.
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("OMP_NUM_THREADS", "1")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import numpy as np  # noqa: E402
import jax  # noqa: E402

import ninpol_tpu  # noqa: E402,F401  (sets x64 + "highest" precision)
from bench import build_problem, card_info  # noqa: E402
from utils.oracle import gls_oracle, idw_oracle, ls_oracle  # noqa: E402

N_MESH = 68             # tetra_mesh(68): the reference's largest tetra scale
N_SUB = 4096            # oracle subsample (exact, idw, ls)
N_SUB_GLS = 1024        # its first part, for the fast GLS path
MAX_BAD_SHARE = 0.01    # nodes re-solved on the exact path / nodes solved
SEED = 20261016


class Phases:
    """Runs named phases in order and prints one info line after each."""

    def __init__(self):
        self.card = None

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        wall = time.perf_counter() - t0
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                 for d in jax.devices()]
        print(f"[{name}] wall {wall:.3f} s; peak_bytes_in_use "
              f"{peaks}; card {self.card}", flush=True)
        return out


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
def phase_device(n_devices, card):
    devs = jax.devices()
    d0 = devs[0]
    print(f"platform {d0.platform}; device_kind {d0.device_kind}; "
          f"count {len(devs)}", flush=True)
    check(d0.platform == "gpu",
          f"no GPU: JAX's first device is {d0.platform!r}")
    check(len(devs) >= n_devices,
          f"{n_devices} devices requested, {len(devs)} present")
    check(card is not None, "nvidia-smi gave no card name and power limit")
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache "
          f"{jax.config.jax_compilation_cache_dir}; x64 "
          f"{jax.config.jax_enable_x64}; default matmul precision "
          f"{jax.config.jax_default_matmul_precision}", flush=True)
    check(jax.config.jax_enable_x64, "x64 is off")


def phase_precision():
    from ninpol_tpu.ops.solve import gram_f32
    A = np.random.default_rng(SEED).standard_normal(
        (1024, 132, 73)).astype(np.float32)
    G = np.asarray(jax.jit(gram_f32)(jax.device_put(A, jax.devices()[0])))
    A64 = A.astype(np.float64)
    ref = np.einsum("bmn,bmk->bnk", A64, A64)
    err = float(np.abs(G - ref).max() / np.abs(ref).max())
    print(f"gram f32 (B=1024, m=132, n=73) vs float64: max rel err "
          f"{err:.3e} (limit 1e-5)", flush=True)
    check(err <= 1e-5, f"Gram precision {err:.3e} > 1e-5: TF32 matmuls?")


def fields(interp):
    v2i = interp.variable_to_index
    return dict(
        perm=interp.cells_data[v2i["cells"]["permeability"]],
        dmag=interp.cells_data[v2i["cells"]["diff_mag"]],
        nflag=interp.points_data[v2i["points"]["neumann_flag_u"]].astype(
            np.int64),
        nval=interp.points_data[v2i["points"]["neumann_u"]])


def solved_nodes(interp):
    """Interior + Neumann nodes: the ones GLS actually solves."""
    return np.nonzero(~interp.grid.boundary_points.astype(bool)
                      | (fields(interp)["nflag"] != 0))[0]


def subsample(interp):
    """Seeded nodes among those GLS solves."""
    return np.random.default_rng(SEED).choice(solved_nodes(interp), N_SUB,
                                              replace=False)


def check_n_bad(interp, label):
    """Fail when the last GLS prepare re-solved more than MAX_BAD_SHARE
    of its nodes on the exact f64 path: the fast path has stopped
    converging (e.g. a compiler dropped the df32 lo halves), which the
    fallback would otherwise hide behind correct but ~10x slower
    results."""
    n_bad = interp.gls.last_n_bad
    n_solved = len(solved_nodes(interp))
    check(n_bad is not None, f"{label}: GLS reported no exact-path count")
    check(n_bad <= MAX_BAD_SHARE * n_solved,
          f"{label}: {n_bad} of {n_solved} nodes fell back to the exact "
          f"path (limit {MAX_BAD_SHARE:.0%})")
    return n_bad, n_solved


def oracles(interp, sub):
    """Reference-exact answers on ``sub``: GLS (weights, neumann, cond),
    IDW weights, LS weights and denominators."""
    grid = interp.grid
    f = fields(interp)
    t0 = time.perf_counter()
    Wg, Ng, cond = gls_oracle(grid, sub, f["perm"], f["dmag"], f["nflag"],
                              f["nval"], return_cond=True)
    Wi = idw_oracle(grid, sub, f["nflag"])
    with np.errstate(divide="ignore", invalid="ignore"):
        # degenerate LS denominators (masked below) divide by ~0
        Wl, denom = ls_oracle(grid, sub, f["nflag"], return_denom=True)
    print(f"oracles on {len(sub)} nodes: {time.perf_counter() - t0:.1f} s "
          f"host; {int((cond >= 1e7).sum())} GLS nodes with cond >= 1e7, "
          f"{int((np.abs(denom) <= 1e-8).sum())} degenerate LS "
          f"denominators", flush=True)
    return {"gls": (Wg, Ng, cond < 1e7),
            "idw": (Wi, np.zeros(len(sub)), np.ones(len(sub), bool)),
            "ls": (Wl, np.zeros(len(sub)), np.abs(denom) > 1e-8)}


def dense_err(W, N, ref):
    """Max error of dense (weights, neumann) rows vs an oracle triple,
    relative to max(|oracle|, 1), over the oracle's mask."""
    Wo, No, ok = ref
    ncols = min(W.shape[1], Wo.shape[1])
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    return float(max(np.abs(W[ok][:, :ncols] - Wo[ok][:, :ncols]).max(),
                     np.abs(W[ok][:, ncols:]).max(initial=0.0),
                     np.abs(N[ok] - No[ok]).max()) / scale)


def csr_rows(W_csr, grid, sub):
    """Rows ``sub`` of an interpolate() CSR, in each node's esup order —
    the layout of the oracles (CSR value = weight + neumann weight)."""
    ptr = grid.esup_ptr
    cnt = np.diff(ptr)[sub]
    ri = np.repeat(np.arange(len(sub)), cnt)
    slot = np.arange(len(ri)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    ci = grid.esup[np.repeat(ptr[sub], cnt) + slot]
    out = np.zeros((len(sub), grid.MX_ELEMENTS_PER_POINT))
    out[ri, slot] = np.asarray(W_csr[sub][ri, ci]).ravel()
    return out


def csr_err(W_csr, N, grid, sub, ref):
    """interpolate() output on ``sub`` vs an oracle triple (as dense_err;
    the CSR adds each node's Neumann weight to every entry of its row)."""
    Wo, No, ok = ref
    cnt = np.diff(grid.esup_ptr)[sub]
    Wo_csr = np.where(np.arange(Wo.shape[1])[None, :] < cnt[:, None],
                      Wo + No[:, None], 0.0)
    return dense_err(csr_rows(W_csr, grid, sub), N[sub], (Wo_csr, No, ok))


# ---------------------------------------------------------------------------
def phase_gls(interp, sub, ref):
    grid = interp.grid
    W, N = interp.interpolate("u", "gls")
    check(W.shape == (grid.n_points, grid.n_elems), f"CSR shape {W.shape}")
    check(np.isfinite(W.data).all() and np.isfinite(N).all(),
          "non-finite GLS weights")
    interior = ~grid.boundary_points.astype(bool)
    sums = np.asarray(W.sum(axis=1)).ravel()[interior]
    dev = float(np.abs(sums - 1.0).max())
    check(dev <= 1e-9, f"interior row sums off 1 by {dev:.3e}")
    n_bad, n_solved = check_n_bad(interp, "gls")
    tp = np.arange(grid.n_points)
    Wp, Np = interp.prepare_interpolator("gls", "u", tp)
    s = sub[:N_SUB_GLS]
    err = dense_err(Wp[s], Np[s], tuple(r[:N_SUB_GLS] for r in ref))
    print(f"gls: {grid.n_elems} cells, {grid.n_points} points, nnz "
          f"{W.nnz}; interior row sums within {dev:.2e} of 1; "
          f"re-solved on the exact f64 path: {n_bad} of {n_solved} "
          f"nodes (limit {MAX_BAD_SHARE:.0%}); vs dgels "
          f"oracle on {len(s)} nodes: max rel err {err:.3e} (limit 1e-10)",
          flush=True)
    check(err <= 1e-10, f"gls vs oracle {err:.3e} > 1e-10")
    return Wp, Np


def phase_exact(interp, sub, ref):
    interp.gls.exact = True
    try:
        W, N = interp.prepare_interpolator("gls", "u", sub)
    finally:
        interp.gls.exact = False
    err = dense_err(W, N, ref)
    print(f"exact (float64 Householder) on {len(sub)} nodes vs dgels "
          f"oracle: max rel err {err:.3e} (limit 1e-10)", flush=True)
    check(err <= 1e-10, f"exact vs oracle {err:.3e} > 1e-10")


def phase_simple(interp, sub, refs):
    for method, tol in (("idw", 1e-12), ("ls", 1e-11)):
        W, N = interp.interpolate("u", method)
        check(np.isfinite(W.data).all(), f"non-finite {method} weights")
        err = csr_err(W, N, interp.grid, sub, refs[method])
        print(f"{method}: interpolate() vs oracle on {len(sub)} nodes: max "
              f"err {err:.3e} (limit {tol:g})", flush=True)
        check(err <= tol, f"{method} vs oracle {err:.3e} > {tol:g}")


def phase_device_out(interp, W_host, N_host):
    tp = np.arange(interp.grid.n_points)
    wdev = interp.prepare_interpolator("gls", "u", tp, device_out=True)
    wdev.block_until_ready()
    plats = {d.platform for d in wdev.devices()}
    check(plats == {"gpu"}, f"device_out array lives on {plats}")
    host = np.asarray(wdev)
    ncols = W_host.shape[1]
    same = (np.array_equal(host[:, :ncols], W_host)
            and np.array_equal(host[:, ncols], N_host))
    print(f"device_out: {host.shape} float64 on {sorted(plats)}; bitwise "
          f"equal to the host-delivered weights: {same}", flush=True)
    check(same, "device_out differs from the host-delivered weights")
    return wdev


# ---------------------------------------------------------------------------
def one_device(ph):
    ph.run("precision", phase_precision)
    t0 = time.perf_counter()
    interp, build = build_problem(N_MESH)
    sub = subsample(interp)
    print(f"problem: tetra_mesh({N_MESH}) built in {build:.1f} s (grid), "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    refs = oracles(interp, sub)
    W, N = ph.run("gls", phase_gls, interp, sub, refs["gls"])
    ph.run("exact", phase_exact, interp, sub, refs["gls"])
    ph.run("idw/ls", phase_simple, interp, sub, refs)
    ph.run("device_out", phase_device_out, interp, W, N)


def grid_tables(interp, label, n_dev, split):
    """Print each device's bytes of the device grid's tables and its
    bytes_in_use now (peak_bytes_in_use is a process-wide high-water
    mark, the same for every configuration run after the largest), and
    check that every table is split n_dev ways along its first axis
    (shard_geometry) or held whole on every device."""
    dg = interp.device_grid
    tables = {k: v for k, v in vars(dg).items() if isinstance(v, jax.Array)}
    per_dev = {d: 0 for d in jax.devices()}
    for name, arr in tables.items():
        shards = arr.addressable_shards
        check(len({sh.device for sh in shards}) == n_dev,
              f"{label}: {name} is not on all {n_dev} devices")
        for sh in shards:
            want = arr.shape[0] // n_dev if split else arr.shape[0]
            check(sh.data.shape[0] == want,
                  f"{label}: {name} shard of {sh.data.shape[0]} rows on "
                  f"{sh.device}, expected {want} of {arr.shape[0]}")
            per_dev[sh.device] += sh.data.nbytes
    now = [(d.memory_stats() or {}).get("bytes_in_use")
           for d in jax.devices()]
    print(f"{label}: {len(tables)} grid tables "
          f"{'split' if split else 'replicated'} over {n_dev} devices, "
          f"bytes per device {list(per_dev.values())}; bytes_in_use now "
          f"{now}", flush=True)


def multi_device(ph, n_dev):
    single, _ = build_problem(N_MESH)
    sub = subsample(single)
    refs = oracles(single, sub)
    grid = single.grid
    base = {m: single.interpolate("u", m) for m in ("gls", "idw", "ls")}
    # LS rows whose denominator vanishes are a 0/0 rounding lottery in
    # the reference too; the one-device comparison masks them like the
    # oracle comparison does
    with np.errstate(divide="ignore", invalid="ignore"):
        _, denom = ls_oracle(grid, np.arange(grid.n_points),
                             fields(single)["nflag"], return_denom=True)
    rows = {"gls": slice(None), "idw": slice(None),
            "ls": np.abs(denom) > 1e-8}
    print(f"LS: {int((np.abs(denom) <= 1e-8).sum())} degenerate "
          f"denominators masked in the one-device comparison", flush=True)
    for label, kw in ((f"mesh={n_dev}", {}),
                      (f"mesh={n_dev}, shard_geometry",
                       {"shard_geometry": True})):
        interp, _ = build_problem(N_MESH, mesh=n_dev, **kw)
        check(interp.mesh is not None
              and interp.mesh.devices.size == n_dev, "mesh not built")

        def methods(interp=interp, label=label):
            for m in ("gls", "idw", "ls"):
                W, N = interp.interpolate("u", m)
                if m == "gls":
                    n_bad, n_solved = check_n_bad(interp, f"{label} gls")
                    print(f"{label} gls: re-solved on the exact f64 path: "
                          f"{n_bad} of {n_solved} nodes", flush=True)
                W1, N1 = base[m]
                r = rows[m]
                scale = max(abs(W1[r]).max(), 1.0)
                d1 = float(max(abs(W[r] - W1[r]).max(),
                               np.abs(N[r] - N1[r]).max()) / scale)
                do = csr_err(W, N, grid, sub, refs[m])
                print(f"{label} {m}: vs one device max rel diff {d1:.3e} "
                      f"(limit 1e-12); vs oracle on {len(sub)} nodes "
                      f"{do:.3e} (limit 1e-10)", flush=True)
                check(d1 <= 1e-12, f"{label} {m} vs one device {d1:.3e}")
                check(do <= 1e-10, f"{label} {m} vs oracle {do:.3e}")
        ph.run(label, methods)
        grid_tables(interp, label, n_dev, split="shard_geometry" in kw)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: every one-GPU phase; N > 1: only the "
                         "N-device mesh path and its comparisons")
    args = ap.parse_args()
    ph = Phases()
    try:
        card = card_info()
        ph.card = "; ".join(card.splitlines()) if card else None
        ph.run("device", phase_device, args.devices, card)
        if args.devices > 1:
            multi_device(ph, args.devices)
        else:
            one_device(ph)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    d0 = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
