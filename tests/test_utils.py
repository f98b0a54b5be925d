"""Logger, meshgen, and df32 utility coverage."""
import os

import numpy as np
import pytest

from ninpol_tpu.utils.logger import Logger, arr_to_dict
from ninpol_tpu.utils import meshgen


def test_logger_file_mode(tmp_path):
    log = Logger("t", terminal=False, directory=str(tmp_path), logging=True)
    log.log("hello", "INFO")
    log.log("warn msg", "WARN")
    files = [f for f in os.listdir(tmp_path) if f.endswith(".log")]
    assert len(files) == 1
    content = open(tmp_path / files[0]).read()
    assert "hello" in content and "[WARN " in content
    # collision-avoiding index suffix (reference logger.pyx:38-44)
    log2 = Logger("t", terminal=False, directory=str(tmp_path), logging=True)
    log2.log("second", "INFO")
    assert len([f for f in os.listdir(tmp_path)
                if f.endswith(".log")]) == 2


def test_logger_json(tmp_path):
    log = Logger("j", terminal=False, directory=str(tmp_path), logging=True)
    log.json("metrics", {"a": np.arange(3), "nested": {"b": 1}})
    jf = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(jf) == 1
    assert '"metrics"' in open(tmp_path / jf[0]).read()


def test_logger_disabled_is_silent(capsys, tmp_path):
    log = Logger("s", terminal=True, logging=False)
    log.log("nope", "INFO")
    assert capsys.readouterr().out == ""


def test_arr_to_dict():
    assert arr_to_dict(np.array([5, 6])) == {0: 5, 1: 6}


@pytest.mark.parametrize("fam", list(meshgen.FAMILIES))
def test_meshgen_families_valid(fam):
    mesh = meshgen.FAMILIES[fam](2)
    n_pts = len(mesh.points)
    for block in mesh.cells:
        assert block.data.min() >= 0
        assert block.data.max() < n_pts
        # no degenerate cells (repeated points)
        for row in block.data[:8]:
            assert len(set(row.tolist())) == len(row)


@pytest.mark.parametrize("fam", ["hexa", "tetra", "prism", "mixed",
                                 "misc"])
def test_meshgen_families_conforming(fam):
    """Every interior face must be shared by exactly two cells: no point
    strictly inside the unit cube may be flagged boundary (a hanging
    diagonal on a shared face would surface here — the old hexa|tetra
    'mixed' family failed this)."""
    from ninpol_tpu.interpolator import Interpolator
    mesh = meshgen.FAMILIES[fam](3)
    interp = Interpolator()
    interp.load_mesh(mesh_obj=mesh)
    g = interp.grid
    coords = g.point_coords
    interior = ((coords > 1e-9) & (coords < 1 - 1e-9)).all(axis=1)
    assert not (interior & g.boundary_points.astype(bool)).any()


def test_df32_pow_accuracy():
    """df32 pow must stay within
    ~1e-12 of float64 pow over the tau domain; includes integer-adjacent
    exponent products (an exact-2^k regression: jnp.exp2 is off by an
    ulp at some integers) and the exp2 split edge where |y - round(y)|
    is tiny."""
    import jax.numpy as jnp
    from ninpol_tpu.ops import df32

    rng = np.random.default_rng(3)
    x = np.exp(rng.uniform(np.log(1e-6), np.log(10.0), 20000))
    e = rng.uniform(0.0, 1.5, 20000)
    # force some near-integer y = -e*log2(x) cases
    x[:100] = 2.0 ** np.arange(1, 101) ** 0.5  # irrational-ish spread
    ref = x ** (-e)
    out = df32.to_f64(df32.powd(df32.from_f64(jnp.asarray(x)),
                                df32.from_f64(jnp.asarray(-e))))
    rel = np.abs(np.asarray(out) - ref) / ref
    assert rel.max() < 1e-12, rel.max()

    lg = np.asarray(df32.to_f64(df32.log2(df32.from_f64(jnp.asarray(x)))))
    assert np.abs(lg - np.log2(x)).max() < 1e-12
    p2 = np.asarray(df32.to_f64(df32.exp2(df32.from_f64(
        jnp.asarray(np.array([0.0, 1.0, 26.0, -13.0, 25.99999999]))))))
    assert np.array_equal(p2[:4], [1.0, 2.0, 2.0 ** 26, 2.0 ** -13])
    assert abs(p2[4] - 2.0 ** 25.99999999) / 2.0 ** 26 < 1e-12


def test_bucket_chunk_plan_bounds():
    """The chunk planner's two contracts: at most THREE distinct (E, F, B)
    programs per bucket class per run (every distinct program is one more
    compile and load), and bounded padding (a tail chunk pads by at most 4x its real nodes —
    a single fixed tail quantum once padded a 27-node CPU-test bucket to
    8192, 70 s/call)."""
    import numpy as np
    from ninpol_tpu.interpolator import Interpolator
    from ninpol_tpu.utils import meshgen
    from ninpol_tpu._methods.device_grid import DeviceGrid

    interp = Interpolator()
    interp.load_mesh(mesh_obj=meshgen.tetra_mesh(6))
    dg = DeviceGrid(interp.grid)
    tp = np.arange(interp.grid.n_points)
    rng = np.random.default_rng(0)
    for frac in (1.0, 0.37, 0.011):
        mask = rng.random(len(tp)) < frac
        if not mask.any():
            continue
        shapes = {}
        total_pad = total_real = 0
        for b in dg.buckets(tp, mask, chunk_size=32768,
                            chunk_elems=int(4.6e8)):
            key = (b["E"], b["F"])
            shapes.setdefault(key, set()).add(len(b["pos"]))
            total_pad += len(b["pos"])
            total_real += int(b["valid"].sum())
        assert total_real == mask.sum()
        for key, sizes in shapes.items():
            assert len(sizes) <= 3, (key, sizes)
        # global padding bound: every real node is covered, and padding
        # never exceeds 4x the real work plus one batch_align quantum
        # per class
        assert total_pad <= 4 * total_real + 256 * sum(
            len(s) for s in shapes.values()), (total_pad, total_real)


def test_df32_exp2_saturates():
    """Regression: the exponent-field construction of 2^k in
    df32.exp2 must SATURATE outside [-126, 127] instead of silently
    wrapping the f32 exponent field (tau_base 1e-30 with eta > 1.27 can
    reach |x| > 126 through powd)."""
    import jax.numpy as jnp
    from ninpol_tpu.ops import df32

    x = jnp.asarray(np.array([-300.0, -126.0, 0.0, 100.0, 300.0]))
    out = np.asarray(df32.to_f64(df32.exp2(df32.from_f64(x))))
    assert np.all(np.isfinite(out)) and np.all(out > 0)
    # in-domain values stay accurate
    assert abs(out[1] - 2.0 ** -126) / 2.0 ** -126 < 1e-10
    assert out[2] == 1.0
    assert abs(out[3] - 2.0 ** 100) / 2.0 ** 100 < 1e-10
    # saturated values degrade monotonically (no wrap to the other end)
    assert out[0] <= out[1] and out[4] >= out[3]
