"""Interpolator facade: CSR assembly semantics, caching, data management,
mesh I/O round-trips."""
import os

import numpy as np
import pytest
import scipy.sparse as sp

from ninpol_tpu._io import mesh as mio
from ninpol_tpu.interpolator import Interpolator
from ninpol_tpu.utils import meshgen
from tests.utils.cases import ALHCase, LINCase


def setup(fam="hexa", n=3, Case=ALHCase):
    case = Case()
    case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=0)
    interp = Interpolator()
    interp.load_mesh(mesh_obj=case.mesh)
    return case, interp


def test_csr_assembly_semantics():
    case, interp = setup()
    grid = interp.grid
    tp = np.arange(grid.n_points)
    Wm, NW = interp.prepare_interpolator("gls", case.name, tp)
    Wcsr, NW2 = interp.interpolate(case.name, "gls")
    assert np.array_equal(NW, NW2)
    assert Wcsr.shape == (grid.n_points, grid.n_elems)
    # per reference interpolator.pyx:612-618: entry = weight + neumann_ws
    dense = Wcsr.toarray()
    for p in range(0, grid.n_points, 5):
        elems = grid.esup[grid.esup_ptr[p]:grid.esup_ptr[p + 1]]
        expect = Wm[p, :len(elems)] + NW[p]
        # eliminate_zeros drops exact zeros; compare via dense
        assert np.allclose(dense[p, elems], expect, atol=1e-15)
    # Dirichlet rows eliminated entirely
    dirichlet = (grid.boundary_points.astype(bool)
                 & (interp.points_data[interp.variable_to_index["points"][
                     f"neumann_flag_{case.name}"]] == 0))
    assert np.abs(dense[dirichlet]).max() == 0


def test_interpolate_errors():
    case, interp = setup()
    with pytest.raises(ValueError, match="not supported"):
        interp.interpolate(case.name, "nope")
    with pytest.raises(ValueError, match="not found"):
        interp.interpolate("missing_var", "idw")
    fresh = Interpolator()
    with pytest.raises(ValueError, match="Grid not initialized"):
        fresh.interpolate("x", "idw")


def test_mesh_file_cache_roundtrip(tmp_path):
    mesh = meshgen.hexa_mesh(3)
    case = LINCase()
    case.assign_mesh_properties(mesh, seed=0)
    path = str(tmp_path / "m.vtk")
    mio.write(path, case.mesh)

    i1 = Interpolator()
    i1.load_mesh(path)
    assert i1.is_cached(path)
    W1, _ = i1.interpolate("LIN", "gls")

    i2 = Interpolator()
    i2.load_mesh(path)  # from cache
    W2, _ = i2.interpolate("LIN", "gls")
    assert np.abs((W1 - W2).toarray()).max() == 0
    os.remove(i1.is_cached(path))


@pytest.mark.parametrize("fmt,binary,ver", [
    ("msh", False, "2.2"), ("msh", True, "2.2"),
    ("msh", False, "4.1"), ("msh", True, "4.1"),
    ("vtk", False, "-"), ("vtk", True, "-"),
])
def test_mesh_io_roundtrip(fmt, binary, ver, tmp_path):
    mesh = meshgen.mixed_hexa_tetra_mesh(2)
    path = str(tmp_path / f"m.{fmt}")
    if fmt == "msh":
        mio.write(path, mesh, binary=binary, msh_version=ver)
    else:
        mio.write(path, mesh, binary=binary)
    back = mio.read(path)
    assert np.allclose(back.points, mesh.points)
    assert {b.type: len(b) for b in back.cells} == \
        {b.type: len(b) for b in mesh.cells}
    d1 = {b.type: b.data for b in mesh.cells}
    d2 = {b.type: b.data for b in back.cells}
    for t in d1:
        assert np.array_equal(d1[t], d2[t])


def test_gmsh2_noncontiguous_tags(tmp_path):
    """v2.2 files with sparse node tags must remap connectivity
    consistently (the tag->index remap is threaded to the element
    parser — a 1-based assumption would silently scramble cells)."""
    path = str(tmp_path / "gap.msh")
    # tags 10, 20, 30, 40 (sorted order = tag order here)
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n4\n"
                "10 0 0 0\n20 1 0 0\n30 0 1 0\n40 0 0 1\n$EndNodes\n"
                "$Elements\n1\n1 4 2 0 0 10 20 30 40\n$EndElements\n")
    m = mio.read(path)
    assert m.cells[0].type == "tetra"
    assert np.array_equal(m.cells[0].data, [[0, 1, 2, 3]])
    assert np.allclose(m.points, [[0, 0, 0], [1, 0, 0],
                                  [0, 1, 0], [0, 0, 1]])


def test_vtk_binary_data_roundtrip(tmp_path):
    mesh = meshgen.tetra_mesh(2)
    n_cells = sum(len(b) for b in mesh.cells)
    rng = np.random.default_rng(0)
    mesh.cell_data = {"perm": [rng.standard_normal((n_cells, 9))]}
    mesh.point_data = {"u": rng.standard_normal(len(mesh.points))}
    path = str(tmp_path / "d.vtk")
    mio.write(path, mesh, binary=True)
    back = mio.read(path)
    assert np.allclose(back.cell_data_dict["perm"]["tetra"],
                       mesh.cell_data["perm"][0])
    assert np.allclose(back.point_data["u"], mesh.point_data["u"])


def test_vtk_data_roundtrip(tmp_path):
    case = LINCase()
    case.assign_mesh_properties(meshgen.hexa_mesh(2), seed=0)
    # vtk writer currently persists geometry only; data survives via the
    # meshio-compatible Mesh object
    m = case.mesh
    assert "permeability" in m.cell_data
    assert m.cell_data_dict["permeability"]["hexahedron"].shape[1] == 9
    assert f"neumann_flag_LIN" in m.point_data


def test_repeated_interpolate_identical():
    """Back-to-back interpolate() calls (fresh prepare each time) must
    be identical — eliminate_zeros() compacts CSR indices in place, so
    the cached column pattern must never be handed to it directly."""
    case = LINCase()
    case.assign_mesh_properties(meshgen.hexa_mesh(3), seed=0)
    interp = Interpolator()
    interp.load_mesh(mesh_obj=case.mesh)
    W1, _ = interp.interpolate(case.name, "idw")
    interp._prep_cache = {}
    W2, _ = interp.interpolate(case.name, "idw")
    assert (W1 != W2).nnz == 0
    assert np.array_equal(W1.indices, W2.indices)


def test_load_data_invalidates_face_cache():
    """Reloading cell data (new permeability) must invalidate the GLS
    device face-flux cache.  Regression for the id()-keyed cache: after
    GC a new data array could reuse a freed array's id() and silently be
    served the stale flux vectors."""
    case, interp = setup(fam="tetra", n=3)
    tp = np.arange(interp.grid.n_points)
    W1, _ = interp.prepare_interpolator("gls", case.name, tp)
    # perturb the permeability anisotropy and reload through the public
    # path; also drop references so ids CAN be reused
    v2i = interp.variable_to_index["cells"]
    n_elems = interp.grid.n_elems
    perm = interp.cells_data[v2i["permeability"]][:n_elems * 9] \
        .reshape(-1, 3, 3).copy()
    perm[:, 0, 0] *= 3.0
    sol = interp.cells_data[v2i[case.name]][:n_elems].copy()
    dmag = interp.compute_diffusion_magnitude(perm.reshape(-1, 9))
    interp.load_data({"permeability": perm.reshape(-1, 9),
                      case.name: sol, "diff_mag": dmag}, "cells")
    W2, _ = interp.prepare_interpolator("gls", case.name, tp)
    assert np.abs(W1 - W2).max() > 1e-8   # weights actually changed
    # and they match a fresh interpolator fed the new data
    fresh = Interpolator()
    fresh.load_mesh(mesh_obj=case.mesh)
    fresh.load_data({"permeability": perm.reshape(-1, 9),
                     case.name: sol, "diff_mag": dmag}, "cells")
    W3, _ = fresh.prepare_interpolator("gls", case.name, tp)
    assert np.abs(W2 - W3).max() < 1e-12


def test_gls_settings_invalidate_prep_cache():
    """interpolate()'s prepared-weights cache key must include every GLS
    knob that changes the result (n_refine/fallback_tol were missing)."""
    case, interp = setup(fam="tetra", n=3)
    W1, _ = interp.interpolate(case.name, "gls")
    keys1 = set(interp._prep_cache)
    interp.gls.n_refine = 5
    interp.interpolate(case.name, "gls")
    keys2 = set(interp._prep_cache)
    assert keys2 - keys1, "changed n_refine must miss the prep cache"
    interp.gls.fallback_tol = 1e-9
    interp.interpolate(case.name, "gls")
    assert set(interp._prep_cache) - keys2, \
        "changed fallback_tol must miss the prep cache"


def test_device_out_matches_host():
    """prepare_interpolator(device_out=True) returns the consolidated
    device array [weights | neumann] matching the host contract."""
    case = LINCase()
    case.assign_mesh_properties(meshgen.tetra_mesh(3), seed=0)
    interp = Interpolator()
    interp.load_mesh(mesh_obj=case.mesh)
    tp = np.arange(interp.grid.n_points)
    W, NW = interp.prepare_interpolator("gls", case.name, tp)
    dev = interp.prepare_interpolator("gls", case.name, tp,
                                      device_out=True)
    dev = np.asarray(dev)
    assert dev.shape == (len(tp), W.shape[1] + 1)
    assert np.abs(dev[:, :W.shape[1]] - W).max() < 1e-12
    assert np.abs(dev[:, W.shape[1]] - NW).max() < 1e-12
    # idw/ls device_out: the neumann
    # column is zero (idw.pyx/ls.pyx never write it)
    for m in ("idw", "ls"):
        Wm, _ = interp.prepare_interpolator(m, case.name, tp)
        dm = np.asarray(interp.prepare_interpolator(m, case.name, tp,
                                                    device_out=True))
        assert np.abs(dm[:, :Wm.shape[1]] - Wm).max() == 0.0
        assert np.abs(dm[:, Wm.shape[1]]).max() == 0.0


def test_load_face_data():
    case, interp = setup()
    grid = interp.grid
    vals = np.arange(grid.n_faces, dtype=float)[:, None]
    interp.load_face_data({"flux": vals})
    assert np.array_equal(interp.faces_data[0], vals[:, 0])
    # with permuted connectivity mapping
    perm = np.random.default_rng(0).permutation(grid.n_faces)
    conn = grid.inpofa[perm]
    interp.load_face_data({"flux": vals[perm]}, face_connectivity=conn)
    assert np.allclose(interp.faces_data[0], vals[:, 0])


def test_get_data_and_dict():
    case, interp = setup()
    d = interp.get_dict()
    assert "variable_to_index" in d
    idx = np.arange(4)
    vals = interp.get_data("cells", idx, "diff_mag")
    assert vals.shape == (4,)
    with pytest.raises(ValueError):
        interp.get_data("cells", idx, "nope")


def test_vector_data_rejected():
    case, interp = setup()
    with pytest.raises(ValueError, match="more than one dimension"):
        interp.interpolate("permeability", "idw")


def test_face_data_to_node():
    from ninpol_tpu.utils.face_data_to_node import face_data_to_node
    case, interp = setup("hexa", 3)
    grid = interp.grid
    # a linear field sampled at face centers must be reproduced exactly
    # at nodes by neither method (they're averages), but "mean" over a
    # CONSTANT field is exact, and idw of a linear field converges
    const = np.full(grid.n_faces, 7.5)
    out = face_data_to_node(grid, const, method="mean")
    assert np.allclose(out, 7.5)
    lin = grid.faces_centers.sum(axis=1)
    out = face_data_to_node(grid, lin, method="idw")
    ref = grid.point_coords.sum(axis=1)
    assert np.abs(out - ref).max() < 0.35  # averaged, h-level accuracy
    # vector data
    out2 = face_data_to_node(grid, np.stack([const, lin], axis=1))
    assert out2.shape == (grid.n_points, 2)
