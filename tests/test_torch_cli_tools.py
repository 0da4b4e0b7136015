"""Slice parity: the port's registration tools (the plot, ``find_transform``,
``analyze_registration``, ``test_aligner``) against the JAX package's, on
the CPU.

Every port command runs with ``--device cpu`` in a subprocess where jax and
the JAX package cannot be imported (``test_torch_cli._cli_start``; commands
of one test run one after another in one process); the JAX commands run in
this process through their scripts' ``main``.  On both sides every analyzer
result and every pairwise aligner transform of the run is recorded at full
precision (``_record``), in call order.  The input is the 10 cm polyhedron
of tests/test_torch_gicp_flow.py (3 tiles, 4,000 points), whose normals are
all determined, written once as a PLY file both read.  Tolerances:

* the ``Plotter``'s and ``plot_analysis_results``' arrays (every curve and
  marker they draw, captured at ``Axes.plot``/``axvline``) equal the JAX
  package's on the same results; no pixel is compared;
* ``find_transform``: every transform within 1e-5 m and 1e-5 rad of the JAX
  CLI's (``chip_smoke.pose_distance``), the analyses before and after
  within 1e-6 relative or 1e-6 m (a cloud aligned to itself leaves
  distances of float32 rounding, ~1e-5 m), their counts equal;
* ``analyze_registration`` in every mode of its docstring (default,
  ``--pairwise``, ``--toself --nth``, ``--totile`` with ``--overlap``,
  ``--occupancy`` and ``--plot``, ``--togroundtruth``, the measures
  ``tmean``, ``2mode`` and ``q=30``): every correspondence statistic and
  overlap fitness/rmse within 1e-6 relative, counts equal, the occupancy
  lines equal; an unknown measure fails on both sides;
* ``test_aligner`` with its default flow (``MultiCameraIterative``, GICP):
  every pairwise transform of the flow within 1e-5 m and 1e-5 rad, every
  analysis within 1e-6 relative or 1e-6 m (those after a step see the
  poses' float differences: measured up to 6.3e-8 m, 2.1e-5 relative of a
  mode), the aligned cloud's points within 1e-5 m.
  ``--algorithm MultiCameraOneToAllOthers`` must improve every camera, as
  in the JAX test, and is not held to the JAX package: on this scene its
  third camera's ICP ends 1.4e-3 rad apart between runs of the port itself
  on 2 and on 8 CPU threads (float summation order), measured.
"""

import contextlib
import inspect
import io
import json
import re

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
from chip_smoke import pose_distance
from test_torch_cli import _cli_start, _cli_wait, _jax_main
from test_torch_gicp_flow import _scenes

import cwipc_util_tpu as jc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu.registration import abstract as jabstract
from cwipc_util_tpu.registration import analyze as janalyze
from cwipc_util_tpu.registration import fine as jfine
from cwipc_util_tpu.registration import plot as jplot
from cwipc_util_tpu.scripts import cwipc_analyze_registration as j_analyze
from cwipc_util_tpu.scripts import cwipc_find_transform as j_find
from cwipc_util_tpu.scripts import cwipc_test_aligner as j_aligner
from cwipc_util_tpu_torch.core.errors import CwipcError
from cwipc_util_tpu_torch.registration import analyze, plot
from cwipc_util_tpu_torch.scripts.cwipc_find_transform import TransformFinder


def _record(analyze_mod, fine_mod, out, patch=setattr):
    """Append to ``out``, in call order, every analyzer result and every
    pairwise aligner transform the run returns, at full precision."""
    import numpy

    def wrap(cls, name, conv):
        real = getattr(cls, name)

        def rec(self, *a, **kw):
            got = real(self, *a, **kw)
            out.append([name, conv(got)])
            return got

        patch(cls, name, rec)

    stats = ("minCorrespondence", "minCorrespondenceCount", "mean", "stddev", "tmean", "mode", "median")
    wrap(analyze_mod.RegistrationAnalyzer, "get_results",
         lambda r: [None if getattr(r, s) is None else float(getattr(r, s)) for s in stats])
    wrap(analyze_mod.OverlapAnalyzer, "get_results", lambda r: [float(r.fitness), float(r.rmse)])
    wrap(fine_mod.RegistrationComputer, "get_result_transformation",
         lambda m: numpy.asarray(m, numpy.float64).tolist())


PRELUDE = ("from cwipc_util_tpu_torch.registration import analyze, fine\n" + inspect.getsource(_record)
           + "_record(analyze, fine, RECORDED)\n")


def _port_start(cwd, commands, parts=1):
    """The port's commands (each a tuple: command and arguments) with
    ``--device cpu``, in ``parts`` jax-less subprocesses at once, each
    running a contiguous share of them one after another."""
    size = -(-len(commands) // parts)
    procs = []
    for i in range(0, len(commands), size):
        args = []
        for argv in commands[i:i + size]:
            args += [*(("--then",) if args else ()), *argv, "--device", "cpu"]
        procs.append(_cli_start(cwd, *args, prelude=PRELUDE))
    return procs


def _port_finish(procs):
    """(the runs, each command's stdout and exit code, what was recorded),
    in command order."""
    rvs, outs, recorded = [], [], []
    for proc in procs:
        rv = _cli_wait(proc)
        parts = re.split(r"^=== exit (-?\d+)\n", rv.stdout, flags=re.M)
        outs += list(zip(parts[0:-1:2], (int(c) for c in parts[1::2]))) or [(rv.stdout, rv.returncode)]
        recorded += next(json.loads(line[len("recorded "):]) for line in rv.stderr.splitlines()
                         if line.startswith("recorded "))
        rvs.append(rv)
    return rvs, outs, recorded


def _jax_run(cwd, monkeypatch, module, commands):
    """The JAX commands in this process: (each command's stdout and exit
    code, what was recorded)."""
    recorded, outs = [], []
    with monkeypatch.context() as m:
        _record(janalyze, jfine, recorded, m.setattr)
        for argv in commands:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rc = _jax_main(module, cwd, monkeypatch, *argv)
            outs.append((out.getvalue(), rc))
    return outs, recorded


def _hold(got, want, rtol=1e-6, atol=0.0, max_dist=1e-5):
    """The recorded runs agree: the same calls in the same order; analyses
    within rtol relative (or atol metres) with equal counts, transforms
    within max_dist m and rad."""
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want, strict=True):
        if name == "get_result_transformation":
            dt, dr = pose_distance(np.asarray(w), np.asarray(g))
            assert dt <= max_dist and dr <= max_dist, (dt, dr)
            continue
        if len(g) == 7:
            assert g[1] == w[1], (g, w)
            g, w = g[:1] + g[2:], w[:1] + w[2:]
        assert [v is None for v in g] == [v is None for v in w]
        np.testing.assert_allclose([v for v in g if v is not None], [v for v in w if v is not None], rtol=rtol,
                                   atol=atol)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    j_scene, _ = _scenes(0.1, 4, 0.01)
    jc.cwipc_write(str(d / "scene.ply"), j_scene, jc.CWIPC_FLAGS_BINARY)
    return d


def test_plotter_arrays_equal_the_jax_plotter(tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.axes import Axes

    rng = np.random.default_rng(3)
    results = []
    for tile, ref in ((1, 6), (2, 5), (4, 3)):
        src = np.zeros(600, port.POINT_DTYPE)
        ref_pts = np.zeros(900, port.POINT_DTYPE)
        for a, t in ((src, tile), (ref_pts, ref & -ref)):
            for f in ("x", "y", "z"):
                a[f] = rng.uniform(0, 0.3, len(a))
            a["tile"] = t
        an = analyze.RegistrationAnalyzer()
        an.set_source_pointcloud(port.cwipc_from_numpy_array(src, 0, device="cpu"), tile)
        an.set_reference_pointcloud(port.cwipc_from_numpy_array(ref_pts, 0, device="cpu"), ref)
        an.run()
        results.append(an.get_results())

    def as_jax(r):
        j = jabstract.AnalysisResults()
        j.__dict__.update(r.__dict__)
        return j

    drawn = []
    real_plot, real_axvline = Axes.plot, Axes.axvline

    def plot_rec(self, *a, **kw):
        drawn[-1].append(("plot", [np.asarray(v, np.float64) for v in a], kw.get("color")))
        return real_plot(self, *a, **kw)

    def axvline_rec(self, x=0, *a, **kw):
        drawn[-1].append(("axvline", [np.float64(x)], kw.get("color")))
        return real_axvline(self, x, *a, **kw)

    monkeypatch.setattr(Axes, "plot", plot_rec)
    monkeypatch.setattr(Axes, "axvline", axvline_rec)
    for pkg, rs in ((plot, results), (jplot, [as_jax(r) for r in results])):
        drawn.append([])
        p = pkg.Plotter("parity")
        p.set_results(rs)
        p.plot(str(tmp_path / f"{pkg.__name__}.png"), which=["all", "log"])
        pkg.plot_analysis_results(rs, filename=str(tmp_path / f"{pkg.__name__}.all.png"))
    got, want = drawn
    assert len(got) == len(want) > 20
    for (kg, ag, cg), (kw_, aw, cw) in zip(got, want, strict=True):
        assert (kg, cg) == (kw_, cw)
        for a, b in zip(ag, aw, strict=True):
            np.testing.assert_array_equal(a, b)
    assert all((tmp_path / f"{pkg.__name__}{ext}").stat().st_size > 1000
               for pkg in (plot, jplot) for ext in (".png", ".all.png"))


def test_plot_without_matplotlib_raises(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(CwipcError, match="matplotlib"):
        plot._get_plt()


def test_find_transform_matches_the_jax_cli(scene, monkeypatch):
    commands = [("--sourcetile", "1", "--targettile", "6", "--plot", "ft.png", "scene.ply"),
                ("--algorithm", "RegistrationComputer_ICP_Point2Point", "--correspondence", "0.005", "scene.ply")]
    procs = _port_start(scene, [("find_transform", *argv) for argv in commands], parts=2)
    want_outs, want = _jax_run(scene, monkeypatch, j_find, commands)  # while the port's run
    rvs, outs, got = _port_finish(procs)
    assert [rv.returncode for rv in rvs] == [0, 0], rvs[-1].stderr[-1500:]
    assert [rc for _, rc in outs] == [rc for _, rc in want_outs] == [0, 0]
    _hold(got, want, atol=1e-6)
    # the tile against the other two moves; the file against itself stays
    transforms = [np.asarray(v) for n, v in got if n == "get_result_transformation"]
    assert len(transforms) == 2
    assert max(pose_distance(transforms[1], np.identity(4))) < 1e-4
    for out, _ in outs:
        assert "Transform filter needed: --filter 'transform44([[" in out
        assert len(re.findall(r"^(Before|After) alignment: correspondence", out, re.M)) == 2
    assert (scene / "ft.png").stat().st_size > 1000


@pytest.mark.parametrize("mask", [0, 1, 6, 0x81, 255])
def test_tilefilter_masked_matches_jax(mask):
    """The tools' tile cut (a compaction on the cloud's device, kernel 3 on
    CUDA) keeps the JAX package's points in its order, tiles above 127
    included."""
    from cwipc_util_tpu.registration.util import cwipc_tilefilter_masked as j_masked
    from cwipc_util_tpu_torch.registration.util import cwipc_tilefilter_masked

    rng = np.random.default_rng(5)
    pts = np.zeros(3000, port.POINT_DTYPE)
    for f in ("x", "y", "z"):
        pts[f] = rng.uniform(-1, 1, len(pts))
    for f in ("r", "g", "b"):
        pts[f] = rng.integers(0, 256, len(pts))
    pts["tile"] = rng.choice(np.array([1, 2, 4, 0x81, 0x82], np.uint8), len(pts))
    pc = port.cwipc_from_numpy_array(pts, 77, device="cpu")
    pc._set_cellsize(0.01)
    got = cwipc_tilefilter_masked(pc, mask)
    want = j_masked(jc.cwipc_from_numpy_array(pts, 77), mask)
    np.testing.assert_array_equal(got.get_numpy_array(), want.get_numpy_array())
    assert (got.count(), got.timestamp(), got.cellsize(), got._device.type) == (want.count(), 77, 0.01, "cpu")


def test_find_transform_tile_vs_full_file(tmp_path):
    """As tests/test_scripts.py's: with --sourcetile and no target file the
    target is the source file re-read whole, and --targettile selects from
    that file, not from the source tile."""
    import argparse

    pts = [(float(i) * 0.01, 0.0, 0.0, 128, 128, 128, 1 if i < 40 else 2) for i in range(100)]
    f = tmp_path / "two_tiles.cwipcdump"
    port.cwipc_write_debugdump(str(f), port.cwipc_from_points(pts, 0, device="cpu"))
    args = argparse.Namespace(sourcetile=1, targettile=0, verbose=0, measure=None, correspondence=-1,
                              dump=False, plot=None, output=None, device="cpu")
    finder = TransformFinder(args)
    finder.load_source(str(f))
    finder.load_target(None)
    assert (finder.source.count(), finder.target.count()) == (40, 100)
    assert finder.source._device.type == finder.target._device.type == "cpu"
    args.targettile = 2
    finder = TransformFinder(args)
    finder.load_source(str(f))
    finder.load_target(None)
    assert (finder.source.count(), finder.target.count()) == (40, 60)


def test_analyze_registration_modes_match_the_jax_cli(scene, monkeypatch):
    modes = [(), ("--pairwise",), ("--toself", "--nth", "1"),
             ("--totile", "1", "--overlap", "--occupancy", "0.01", "--plot", "a.png"),
             ("--togroundtruth", "scene.ply"), ("--measure", "tmean"), ("--measure", "2mode"),
             ("--measure", "q=30")]
    commands = [(*m, "scene.ply") for m in modes]
    procs = _port_start(scene, [("analyze_registration", *argv)
                                for argv in commands + [("--measure", "garbage", "scene.ply")]], parts=2)
    want_outs, want = _jax_run(scene, monkeypatch, j_analyze, commands)  # while the port's run
    with pytest.raises(ValueError, match="Unknown correspondence measure"):
        _jax_main(j_analyze, scene, monkeypatch, "--measure", "garbage", "scene.ply")
    rvs, outs, got = _port_finish(procs)
    assert [rv.returncode for rv in rvs] == [0, 1], rvs[0].stderr[-1500:]
    assert "Unknown correspondence measure 'garbage'" in rvs[1].stderr, rvs[1].stderr[-1500:]
    assert len(outs) == len(commands) and all(rc == 0 for _, rc in outs + want_outs)
    _hold(got, want)
    counts = [out.count("Alignment") for out, _ in outs]
    assert counts == [out.count("Alignment") for out, _ in want_outs] == [3, 6, 3, 4, 3, 3, 3, 3]
    occupancy = [re.findall(r"^Occupancy: .*$", out, re.M) for out, _ in (outs[3], want_outs[3])]
    assert occupancy[0] == occupancy[1] and occupancy[0]
    assert outs[2][0].count("self, nth=1") == 3 and "count: 0," not in outs[2][0]
    assert outs[4][0].count("to 0x0") == 3
    assert (scene / "a.png").stat().st_size > 1000


def test_aligner_matches_the_jax_cli(scene, monkeypatch):
    procs = _port_start(scene, [("test_aligner", "--output", "port.ply", "scene.ply"),
                                ("test_aligner", "--help_algorithms"),
                                ("test_aligner", "--algorithm", "MultiCameraOneToAllOthers", "scene.ply")], parts=2)
    want_outs, want = _jax_run(scene, monkeypatch, j_aligner, [("--output", "jax.ply", "scene.ply")])
    rvs, outs, got = _port_finish(procs)
    assert [rv.returncode for rv in rvs] == [0, 0], rvs[-1].stderr[-1500:]
    assert [rc for _, rc in outs + want_outs] == [0, 0, 0, 0]
    # the default flow (MultiCameraIterative) is held to the JAX CLI's
    _hold(got[:len(want)], want, atol=1e-6)
    assert sum(n == "get_result_transformation" for n, _ in want) == 2
    a = port.cwipc_read(str(scene / "port.ply"), 0, device="cpu").get_numpy_array()
    b = jc.cwipc_read(str(scene / "jax.ply"), 0).get_numpy_array()
    assert len(a) == len(b) == 4000
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(a[f], b[f], rtol=0, atol=1e-5)
    for f in ("r", "g", "b", "tile"):
        np.testing.assert_array_equal(a[f], b[f])
    assert "MultiCameraOneToAllOthers" in outs[1][0] and "RegistrationComputer_ICP_Generalized" in outs[1][0]
    # MultiCameraOneToAllOthers improves every camera, as in the JAX test
    for out in (outs[0][0], outs[2][0]):
        report = re.findall(r"^camera \d \(tile \d\): correspondence (\d+\.\d+) -> (\d+\.\d+)$", out, re.M)
        assert len(report) == 3 and all(float(after) < float(before) for before, after in report), out
