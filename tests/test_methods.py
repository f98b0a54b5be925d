"""Method kernels vs the reference-exact NumPy/LAPACK oracle."""
import numpy as np
import pytest

from ninpol_tpu.interpolator import Interpolator
from ninpol_tpu.utils import meshgen
from tests.utils.cases import ALHCase, LINCase
from tests.utils.oracle import gls_oracle, idw_oracle, ls_oracle


def setup_case(fam="hexa", n=4, Case=ALHCase, seed=0):
    case = Case()
    case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=seed)
    interp = Interpolator()
    interp.load_mesh(mesh_obj=case.mesh)
    return case, interp


def get_fields(interp, var):
    v2i = interp.variable_to_index
    return {
        "perm": interp.cells_data[v2i["cells"]["permeability"]],
        "dmag": interp.cells_data[v2i["cells"]["diff_mag"]],
        "nflag": interp.points_data[
            v2i["points"][f"neumann_flag_{var}"]].astype(np.int64),
        "nval": interp.points_data[v2i["points"][f"neumann_{var}"]],
    }


@pytest.mark.parametrize("fam", ["hexa", "tetra", "prism", "mixed"])
def test_idw_matches_oracle(fam):
    case, interp = setup_case(fam, 3)
    f = get_fields(interp, case.name)
    tp = np.arange(interp.grid.n_points)
    W, _ = interp.prepare_interpolator("idw", case.name, tp)
    Wo = idw_oracle(interp.grid, tp, f["nflag"])
    assert np.abs(W - Wo).max() < 1e-13


@pytest.mark.parametrize("fam", ["hexa", "tetra", "prism", "mixed"])
def test_ls_matches_oracle(fam):
    case, interp = setup_case(fam, 3)
    f = get_fields(interp, case.name)
    tp = np.arange(interp.grid.n_points)
    W, _ = interp.prepare_interpolator("ls", case.name, tp)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Wo, denom = ls_oracle(interp.grid, tp, f["nflag"],
                              return_denom=True)
    # Mask nodes where the reference formula itself degenerates:
    # denom -> 0 produces a 0/0 rounding lottery (arbitrary O(1) or inf
    # values depending on summation order) at planar boundary-Neumann
    # stencils; the reference output there is garbage by construction
    # (ls.pyx:126-136) and is excluded from its own accuracy metrics.
    bad = ~(np.abs(denom) > 1e-8)
    assert np.abs(W[~bad] - Wo[~bad]).max() < 1e-11


@pytest.mark.parametrize("fam,n", [("hexa", 4), ("tetra", 3), ("prism", 3),
                                   ("mixed", 3), ("misc", 3), ("quad", 5),
                                   ("triangle", 5)])
def test_gls_matches_oracle_mixed(fam, n):
    case, interp = setup_case(fam, n)
    f = get_fields(interp, case.name)
    tp = np.arange(interp.grid.n_points)
    W, NW = interp.prepare_interpolator("gls", case.name, tp)
    Wo, NWo, cond = gls_oracle(interp.grid, tp, f["perm"], f["dmag"],
                               f["nflag"], f["nval"], neumann_compat=True,
                               return_cond=True)
    # near-singular stencils (rank-deficient 2D boundary corners): the
    # dgels output is rounding chaos, nothing to match
    ok = cond < 1e7
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    assert np.abs(W[ok] - Wo[ok]).max() / scale < 1e-10
    assert np.abs(NW[ok] - NWo[ok]).max() / scale < 1e-10


def test_gls_exact_path_matches_oracle():
    case, interp = setup_case("tetra", 3)
    f = get_fields(interp, case.name)
    tp = np.arange(interp.grid.n_points)
    interp.gls.exact = True
    W, NW = interp.prepare_interpolator("gls", case.name, tp)
    Wo, NWo = gls_oracle(interp.grid, tp, f["perm"], f["dmag"], f["nflag"],
                         f["nval"], neumann_compat=True)
    assert np.abs(W - Wo).max() < 1e-11
    assert np.abs(NW - NWo).max() < 1e-11


def test_gls_neumann_correct_mode_differs():
    """neumann_compat=False returns the true Neumann-column weight
    (the reference quirk makes compat equal the last cell weight)."""
    case, interp = setup_case("hexa", 4)
    f = get_fields(interp, case.name)
    tp = np.arange(interp.grid.n_points)
    W, NWc = interp.prepare_interpolator("gls", case.name, tp)
    interp.gls.neumann_compat = False
    W2, NWt = interp.prepare_interpolator("gls", case.name, tp)
    assert np.abs(W - W2).max() < 1e-12
    neu = f["nflag"][tp].astype(bool) & (np.abs(NWc) > 0)
    assert neu.any()
    # compat value equals the last cell weight
    counts = np.diff(interp.grid.esup_ptr)[tp]
    last_w = W[np.arange(len(tp)), counts - 1]
    assert np.abs(NWc[neu] - last_w[neu]).max() < 1e-12
    # true Neumann weight differs from the compat one somewhere
    assert np.abs(NWt[neu] - NWc[neu]).max() > 1e-8
    _, NWo = gls_oracle(interp.grid, tp, f["perm"], f["dmag"], f["nflag"],
                        f["nval"], neumann_compat=False)
    assert np.abs(NWt - NWo).max() < 1e-10


def test_gls_asymmetric_permeability():
    """K @ N vs K^T @ N differ for non-symmetric K: the reference's
    dgemv("T") on a row-major buffer computes K @ N (gls.pyx:320-321);
    pin that binary behavior (symmetric-K cases can't see the
    difference)."""
    case, interp = setup_case("tetra", 3)
    g = interp.grid
    rng = np.random.default_rng(7)
    K = np.tile(np.eye(3), (g.n_elems, 1, 1)) * 2.0
    skew = rng.standard_normal((g.n_elems, 3, 3))
    K = K + 0.3 * (skew - np.swapaxes(skew, 1, 2))   # asymmetric part
    assert np.abs(K - np.swapaxes(K, 1, 2)).max() > 1e-2
    dmag = interp.compute_diffusion_magnitude(K.reshape(-1, 9))
    interp.load_data({"permeability": K.reshape(-1, 9),
                      "diff_mag": dmag}, "cells")
    f = get_fields(interp, case.name)
    tp = np.arange(g.n_points)
    W, NW = interp.prepare_interpolator("gls", case.name, tp)
    Wo, NWo, cond = gls_oracle(g, tp, K.reshape(-1, 9), dmag,
                               f["nflag"], f["nval"], neumann_compat=True,
                               return_cond=True)
    ok = cond < 1e7
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    assert np.abs(W[ok] - Wo[ok]).max() / scale < 1e-10
    assert np.abs(NW[ok] - NWo[ok]).max() / scale < 1e-10


def test_dirichlet_rows_are_zero():
    case, interp = setup_case("hexa", 3)
    f = get_fields(interp, case.name)
    tp = np.arange(interp.grid.n_points)
    for method in ("idw", "ls", "gls"):
        W, NW = interp.prepare_interpolator(method, case.name, tp)
        dirichlet = (interp.grid.boundary_points.astype(bool)
                     & (f["nflag"] == 0))
        assert np.abs(W[dirichlet]).max() == 0.0
        assert np.abs(NW[dirichlet]).max() == 0.0


def test_subset_targets():
    case, interp = setup_case("hexa", 3)
    tp_all = np.arange(interp.grid.n_points)
    subset = tp_all[::3]
    Wfull, _ = interp.prepare_interpolator("gls", case.name, tp_all)
    Wsub, _ = interp.prepare_interpolator("gls", case.name, subset)
    assert np.abs(Wsub - Wfull[::3]).max() < 1e-12


def test_fallback_storm_routes_all_nodes_to_exact():
    """fallback_tol below the mixed path's floor forces EVERY active
    node through the rnorm -> exact-f64 re-solve (the device-side n_bad
    count plus the fallback batching), host and device_out deliveries
    both; the result must match a pure exact=True run bit-for-bit."""
    case, interp = setup_case("tetra", 3)
    tp = np.arange(interp.grid.n_points)

    interp.gls.exact = True
    We, NWe = interp.prepare_interpolator("gls", case.name, tp)

    interp.gls.exact = False
    interp.gls.fallback_tol = 0.0          # nothing is provably converged
    Wf, NWf = interp.prepare_interpolator("gls", case.name, tp)
    assert np.abs(We - Wf).max() == 0.0
    assert np.abs(NWe - NWf).max() == 0.0

    wdev = interp.prepare_interpolator("gls", case.name, tp,
                                       device_out=True)
    wd = np.asarray(wdev)
    assert np.abs(wd[:, :We.shape[1]] - We).max() == 0.0
    assert np.abs(wd[:, -1] - NWe).max() == 0.0


def test_all_dirichlet_subset_returns_zero_rows():
    """A target subset consisting only of Dirichlet boundary nodes has
    no active node in either GLS bucket mask — the delivery paths must
    return the zero-filled buffers instead of tripping on an empty
    bucket plan (regression: _group_plan([]) raised ValueError)."""
    case, interp = setup_case("hexa", 3)
    f = get_fields(interp, case.name)
    dirichlet = np.where(interp.grid.boundary_points.astype(bool)
                         & (f["nflag"] == 0))[0][:8]
    assert len(dirichlet) > 0
    for method in ("gls", "idw", "ls"):
        W, NW = interp.prepare_interpolator(method, case.name, dirichlet)
        assert np.abs(W).max() == 0.0 and np.abs(NW).max() == 0.0
        wd = np.asarray(interp.prepare_interpolator(
            method, case.name, dirichlet, device_out=True))
        assert np.abs(wd).max() == 0.0


def _prepare_with_scan_spy(interp, case, tp, chunk_nodes=256):
    """Re-run a GLS prepare with tiny chunks (forcing a multi-chunk
    plan) and a gls._build_scan_units spy; saves/restores chunk_nodes
    from the live attribute (a hardcoded restore silently drifts if the
    default changes).  Returns (W, N, seen_unit_kinds)."""
    from ninpol_tpu._methods import gls as gls_mod

    seen = []
    orig_units = gls_mod._build_scan_units

    def spy(buckets):
        units = orig_units(buckets)
        seen.extend(k for k, _ in units)
        return units

    orig_chunk = interp.gls.chunk_nodes
    gls_mod._build_scan_units = spy
    try:
        interp.gls.chunk_nodes = chunk_nodes
        interp._prep_cache.clear()
        W, N = interp.prepare_interpolator("gls", case.name, tp)
    finally:
        gls_mod._build_scan_units = orig_units
        interp.gls.chunk_nodes = orig_chunk
    return W, N, seen


def test_scan_stacked_chunks_bit_equal():
    """Identical-shape chunks fused into one lax.scan program
    (gls._build_scan_units) must give bit-identical weights to the
    default single-chunk-plan path, and must actually trigger on a
    multi-chunk plan."""
    case, interp = setup_case("hexa", 10)   # 1331 points
    tp = np.arange(interp.grid.n_points)
    W0, N0 = interp.prepare_interpolator("gls", case.name, tp)

    W1, N1, seen = _prepare_with_scan_spy(interp, case, tp)
    assert "scan" in seen
    np.testing.assert_array_equal(W0, W1)
    np.testing.assert_array_equal(N0, N1)


def test_scan_kill_switch(monkeypatch):
    """NINPOL_TPU_NO_SCAN=1 must force per-chunk dispatch (hardware
    fallback knob for scan-over-Pallas lowering regressions) and still
    produce identical weights."""
    case, interp = setup_case("hexa", 10)
    tp = np.arange(interp.grid.n_points)
    W0, N0 = interp.prepare_interpolator("gls", case.name, tp)

    monkeypatch.setenv("NINPOL_TPU_NO_SCAN", "1")
    W1, N1, seen = _prepare_with_scan_spy(interp, case, tp)
    assert not seen                     # _build_scan_units never called
    np.testing.assert_array_equal(W0, W1)
    np.testing.assert_array_equal(N0, N1)


def _simple_tiles(interp):
    """Collect the IDW/LS pre-gather tile cells hanging off the plan
    cache (singles carry _stiles on the bucket dict, scan megabuckets
    on the proto bucket's _scan_unit)."""
    out = []
    for plan in interp.device_grid._plan_cache.values():
        for b in plan:
            out.append(b.get("_stiles"))
            mb = b.get("_scan_unit")
            if mb is not None:
                out.append(mb.get("_stiles"))
    return out


def test_simple_pregather_kill_switch(monkeypatch):
    """NINPOL_TPU_NO_PREGATHER=1 must fall back to in-program stencil
    gathers for IDW/LS (hardware kill switch for gather-lowering
    regressions) and stay bit-identical — the hoisted gather halves do
    no float arithmetic (idw.simple_gather_tiles)."""
    case, interp = setup_case("hexa", 10)
    tp = np.arange(interp.grid.n_points)
    W0 = {m: interp.prepare_interpolator(m, case.name, tp)[0]
          for m in ("idw", "ls")}
    assert any(t is not None for t in _simple_tiles(interp)), \
        "pre-gather tiles never populated — test premise broken"

    monkeypatch.setenv("NINPOL_TPU_NO_PREGATHER", "1")
    case1, interp1 = setup_case("hexa", 10)   # fresh: no cached tiles
    for m in ("idw", "ls"):
        W1, _ = interp1.prepare_interpolator(m, case1.name, tp)
        np.testing.assert_array_equal(W0[m], W1)
    assert all(t is None for t in _simple_tiles(interp1)), \
        "kill switch did not disable the pre-gather tile cache"


def test_simple_fused_device_plan_bit_equal():
    """IDW/LS device_out runs the WHOLE bucket plan + delivery as ONE
    program (idw._run_simple_plan_device — unlike GLS, the simple
    kernels are shorter than the helper's enqueue latency, so fusing
    wins).  On a forced multi-chunk plan with scan stacks, it must be
    bit-identical to the per-unit host delivery."""
    from ninpol_tpu._methods import device_grid as dg

    case, interp = setup_case("hexa", 10)   # 1331 points
    tp = np.arange(interp.grid.n_points)

    seen = []
    orig_units = dg.build_scan_units

    def spy(buckets, extra_keys=()):
        units = orig_units(buckets, extra_keys)
        seen.extend(k for k, _ in units)
        return units

    dg.build_scan_units = spy
    try:
        for m in ("idw", "ls"):
            drv = getattr(interp, m)
            orig_chunk = drv.chunk_nodes
            try:
                drv.chunk_nodes = 256
                interp._prep_cache.clear()
                seen.clear()
                W, _ = interp.prepare_interpolator(m, case.name, tp)
                wd = np.asarray(interp.prepare_interpolator(
                    m, case.name, tp, device_out=True))
            finally:
                drv.chunk_nodes = orig_chunk
            assert "scan" in seen, m
            assert np.abs(wd[:, :W.shape[1]] - W).max() == 0.0, m
            assert np.abs(wd[:, W.shape[1]:]).max() == 0.0, m
    finally:
        dg.build_scan_units = orig_units


def test_mega_plan_device_out_bit_equal(monkeypatch):
    """The single-program device_out plan (gls._run_plan_device — every
    scan unit + the consolidation fused into ONE executable, opt-in via
    NINPOL_TPU_MEGA=1; default stays per-unit dispatch, which measured
    FASTER on hardware) must give bit-identical results to the per-unit
    dispatch path."""
    case, interp = setup_case("hexa", 10)
    tp = np.arange(interp.grid.n_points)
    monkeypatch.setenv("NINPOL_TPU_MEGA", "1")
    wd_mega = np.asarray(interp.prepare_interpolator(
        "gls", case.name, tp, device_out=True))
    monkeypatch.delenv("NINPOL_TPU_MEGA")
    wd_plain = np.asarray(interp.prepare_interpolator(
        "gls", case.name, tp, device_out=True))
    np.testing.assert_array_equal(wd_mega, wd_plain)


def test_face_pack_layout():
    """Pin the 28-column packed face row layout of gls.build_face_pack —
    the ONE construction site shared by GLS.prepare,
    parallel/sharding.sharded_gls and __graft_entry__.entry — and the
    int32 cell-pair table the kernel gathers beside it.  This test goes
    red if any column moves (a silent layout drift between the three
    former copies is exactly the bug class this prevents)."""
    from ninpol_tpu._methods.gls import build_face_pack, \
        precompute_face_data
    case, interp = setup_case("tetra", 2)
    f = get_fields(interp, case.name)
    g = interp.grid
    dg = interp.device_grid
    perm = f["perm"].reshape(-1, 3, 3)
    fp = np.asarray(build_face_pack(dg, perm, f["dmag"], f["nval"]))
    assert fp.shape == (g.n_faces, 28)

    def hi(a):
        return np.asarray(a, np.float64).astype(np.float32)

    def lo(a):
        a = np.asarray(a, np.float64)
        return (a - hi(a).astype(np.float64)).astype(np.float32)

    # the esuf cell pair: its own int32 table, never float bit patterns
    ip = np.asarray(dg.face_ipack)
    assert ip.dtype == np.int32
    np.testing.assert_array_equal(ip, dg.esuf2d_h[:, :2])
    # [0:6] normal hi/lo, [6:12] face-center hi/lo (exact split by
    # construction)
    np.testing.assert_array_equal(fp[:, 0:3], hi(g.normal_faces))
    np.testing.assert_array_equal(fp[:, 3:6], lo(g.normal_faces))
    np.testing.assert_array_equal(fp[:, 6:9], hi(g.faces_centers))
    np.testing.assert_array_equal(fp[:, 9:12], lo(g.faces_centers))
    # [12:28] flux block: K@N both sides, eta, per-face Neumann mean
    nL1g, nL2g, etag, _ = precompute_face_data(g, perm, f["dmag"])
    np.testing.assert_array_equal(fp[:, 12:15], hi(nL1g))
    np.testing.assert_array_equal(fp[:, 15:18], lo(nL1g))
    np.testing.assert_array_equal(fp[:, 18:21], hi(nL2g))
    np.testing.assert_array_equal(fp[:, 21:24], lo(nL2g))
    np.testing.assert_array_equal(fp[:, 24], hi(etag))
    np.testing.assert_array_equal(fp[:, 25], lo(etag))
    nvraw = np.asarray(f["nval"], np.float64)
    ipofa = g.inpofa
    ipv = ipofa >= 0
    nsum = np.where(ipv, nvraw[np.where(ipv, ipofa, 0)], 0.0)
    nmean = nsum.sum(axis=1) / np.maximum(ipv.sum(axis=1), 1)
    np.testing.assert_array_equal(fp[:, 26], hi(nmean))
    np.testing.assert_array_equal(fp[:, 27], lo(nmean))


@pytest.mark.parametrize("fam,n,E,F,wneu", [("hexa", 4, 8, 12, False),
                                            ("mixed", 3, 20, 28, True),
                                            ("tetra", 3, 24, 36, True)])
def test_cholqr_bucket_kernel_matches_oracle(fam, n, E, F, wneu):
    """The XLA CholQR2 + df32 bucket kernel (gls._gls_bucket_kernel,
    solver "cholqr"), called directly on one bucket at a fixed stencil
    class (E, F, with_neumann), vs the dgels oracle.  hexa interior nodes
    form the (8, 12) class themselves.  Small meshes put no Neumann node
    in (20, 28) or (24, 36) — mixed gives (16, 28), tetra (12, 24) — so
    their Neumann nodes run padded up to those classes, as a bucket pads
    its smaller stencils."""
    import jax.numpy as jnp
    from ninpol_tpu._methods.gls import _gls_bucket_kernel, build_face_pack

    case, interp = setup_case(fam, n)
    f = get_fields(interp, case.name)
    g, dg = interp.grid, interp.device_grid
    is_neu = f["nflag"] != 0
    pick = (~(g.boundary_points.astype(bool) & ~is_neu)
            & (is_neu == wneu)
            & (np.diff(g.esup_ptr) <= E) & (np.diff(g.fsup_ptr) <= F))
    nodes = np.nonzero(pick)[0]
    assert len(nodes) >= 8, "test premise: too few nodes in the class"
    B = 256
    nb = np.zeros(B, np.int32)
    nb[:len(nodes)] = nodes
    face_pack = build_face_pack(dg, f["perm"].reshape(-1, 3, 3), f["dmag"],
                                f["nval"])
    out = _gls_bucket_kernel(
        jnp.asarray(nb), jnp.asarray(np.arange(B) < len(nodes)),
        dg.esup2d, dg.esup_cnt, dg.fsup2d, dg.fsup_cnt, dg.point_pack,
        dg.cell_pack, dg.face_ipack, face_pack,
        jnp.asarray(f["nflag"].astype(np.int32)),
        E=E, F=F, n_refine=2, exact=False, neumann_compat=True,
        with_neumann=wneu, solver="cholqr")
    w, wn, rnorm = (np.asarray(x)[:len(nodes)] for x in out)
    assert w.shape[1] == E
    Wo, NWo, cond = gls_oracle(g, nodes, f["perm"], f["dmag"], f["nflag"],
                               f["nval"], return_cond=True)
    ok = (cond < 1e7) & (rnorm <= 1e-11)
    assert ok.sum() >= 0.9 * len(nodes), "fast path left too many nodes"
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    ncols = min(E, Wo.shape[1])
    assert np.abs(w[ok][:, :ncols] - Wo[ok][:, :ncols]).max() / scale < 1e-10
    assert np.abs(Wo[ok][:, ncols:]).max(initial=0.0) == 0.0
    assert np.abs(wn[ok] - NWo[ok]).max() / scale < 1e-10
    if wneu:
        assert np.abs(NWo[ok]).max() > 0, "test premise: no Neumann weight"


def test_gls_unknown_solver_raises():
    """The removed "pallas" solver (or any other unknown solver) is a
    clean ValueError, not a silent fallback."""
    case, interp = setup_case("hexa", 3)
    tp = np.arange(interp.grid.n_points)
    interp.gls.solver = "pallas"
    with pytest.raises(ValueError, match="pallas"):
        interp.prepare_interpolator("gls", case.name, tp)
    with pytest.raises(ValueError, match="pallas"):
        interp.interpolate(case.name, "gls")


def test_gls_refined_solver_matches_oracle():
    """solver="refined" (f32 QR preconditioner + f64 normal-equation
    refinement), the cross-check path beside "cholqr", vs the oracle."""
    case, interp = setup_case("tetra", 3)
    f = get_fields(interp, case.name)
    tp = np.arange(interp.grid.n_points)
    interp.gls.solver = "refined"
    W, NW = interp.prepare_interpolator("gls", case.name, tp)
    Wo, NWo, cond = gls_oracle(interp.grid, tp, f["perm"], f["dmag"],
                               f["nflag"], f["nval"], return_cond=True)
    ok = cond < 1e7
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    assert np.abs(W[ok] - Wo[ok]).max() / scale < 1e-10
    assert np.abs(NW[ok] - NWo[ok]).max() / scale < 1e-10
