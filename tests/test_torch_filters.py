"""The filters and their string factory against the JAX package's, as
tests/test_filters.py drives them: the same names and help text, the same
argument parsing, a custom ``.py`` filter, and the same output cloud for
every filter on the same input.

Outputs are compared record for record, bit for bit, except after
``voxelize``: the fast downsample's centroids are allclose (rtol 1e-6,
atol 1e-6) to the JAX CPU path, which rounds (v + frac) * cell per point
before averaging (ops/voxelize.py)."""

import numpy as np
import pytest

import cwipc_util_tpu as jcwipc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu import filters as jfilters
from cwipc_util_tpu_torch import filters as pfilters

DESCRIPTIONS = [
    "passthrough",
    "analyze",
    "voxelize(0.05)",
    "transform(1.0, 0, 0, 1.0)",
    "transform(0, 0, 0, 2.0)",
    "transform44([[1, 0, 0, 0.1], [0, 0.8, -0.6, 0], [0, 0.6, 0.8, -0.2], [0, 0, 0, 1]])",
    "crop(-1, 1, -1, 1, -1, 1)",
    "crop(-0.2, 0.2, 0.5, 1.5, -0.3, 0.3)",
    "remove_outliers(8, 1.0, False)",
    "remove_outliers(8, 1.0, True)",
    "colorize(1.0, 'camera')",
    "colorize(0.5, 'contributions')",
    "colorize(0.3, (0.1, 0.2, 0.3))",
    "noise(0.01, 3)",
    "simulatecams(4, True)",
    "simulatecams(3, False, 1.5, 7)",
    "direction(0, 0, 1, 0.0)",
    "randomize_floor(0.5)",
]


@pytest.fixture(scope="module")
def cloud():
    """tests/test_filters.py's input: the synthetic body at 2,500 points,
    with tiles from simulatecams so the per-tile and colour paths see
    several tiles."""
    gen = jcwipc.cwipc_synthetic(0, 2500)
    gen.start()
    pc = jfilters.factory("simulatecams(4, True)").filter(gen.get())
    gen.stop()
    return pc.get_numpy_array()


def test_names_and_help(capsys):
    assert sorted(pfilters._by_name) == sorted(jfilters._by_name)
    assert [m.__name__.rsplit(".", 1)[1] for m in pfilters.all_filters] == [
        m.__name__.rsplit(".", 1)[1] for m in jfilters.all_filters]
    jfilters.help()
    want = capsys.readouterr()
    pfilters.help()
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err


@pytest.mark.parametrize("desc", DESCRIPTIONS)
def test_same_output(desc, cloud):
    jf, pf = jfilters.factory(desc), pfilters.factory(desc)
    assert type(pf).__name__ == type(jf).__name__ and pf.filtername == jf.filtername
    np.random.seed(21)  # randomize_floor draws from numpy's global generator
    jout = jf.filter(jcwipc.cwipc_from_numpy_array(cloud, 11))
    np.random.seed(21)
    pout = pf.filter(port.cwipc_from_numpy_array(cloud, 11, device="cpu"))
    assert pout._device.type == "cpu"
    ja, pa = jout.get_numpy_array(), pout.get_numpy_array()
    assert pout.timestamp() == jout.timestamp() and pout.cellsize() == jout.cellsize()
    assert len(pa) == len(ja)
    if desc.startswith(("crop", "remove_outliers", "direction")):
        assert 0 < len(pa) < len(cloud)
    if desc.startswith("voxelize"):
        for f in ("r", "g", "b", "tile"):
            np.testing.assert_array_equal(pa[f], ja[f])
        for f in ("x", "y", "z"):
            np.testing.assert_allclose(pa[f], ja[f], rtol=1e-6, atol=1e-6)
        return
    assert pa.tobytes() == ja.tobytes()


def test_analyze_statistics(cloud, capsys):
    outs = []
    for fl, pkg, kw in ((jfilters, jcwipc, {}), (pfilters, port, {"device": "cpu"})):
        f = fl.factory("analyze")
        f.filter(pkg.cwipc_from_numpy_array(cloud, 0, **kw))
        f.filter(pkg.cwipc_from_numpy_array(cloud[:100], 0, **kw))
        f.statistics()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "avg_centroid" in outs[1]


def test_statistics_runs(cloud, capsys):
    f = pfilters.factory("voxelize(0.05)")
    f.filter(port.cwipc_from_numpy_array(cloud, 0, device="cpu"))
    f.statistics()
    out = capsys.readouterr().out
    assert "voxelize" in out and "count=1" in out


def test_argument_parsing():
    assert pfilters.factory("voxelize(0.05)").vsize == 0.05
    assert pfilters.factory("crop(-1, 1, -1, 1, -1, 1)").bounding_box == (-1, 1, -1, 1, -1, 1)
    assert pfilters.factory("colorize(1.0, 'camera')").weight == 1.0
    assert pfilters.factory("remove_outliers(30, 1.0)").perTile is False
    assert pfilters.factory("noise(0.01)").distance == 0.01


@pytest.mark.parametrize("desc", ["nonexistent", "__import__('os').system('true')", "abstract", "ast(1)"])
def test_unknown_rejected(desc):
    with pytest.raises(ValueError):
        pfilters.factory(desc)
    with pytest.raises(ValueError):
        jfilters.factory(desc)


def test_custom_py(tmp_path, cloud):
    fn = tmp_path / "custom.py"
    fn.write_text(
        "from cwipc_util_tpu_torch.filters.abstract import BaseFilter\n"
        "class CustomFilter(BaseFilter):\n"
        "    filtername = 'custom'\n"
        "    def _process(self, pc):\n"
        "        return pc\n"
    )
    f = pfilters.factory(str(fn))
    assert f.filtername == "custom"
    pc = port.cwipc_from_numpy_array(cloud, 0, device="cpu")
    assert f.filter(pc) is pc and f.count == 1


def test_colorized_copy(cloud):
    from cwipc_util_tpu.registration.util import cwipc_colorized_copy as jcopy
    from cwipc_util_tpu_torch.registration.util import cwipc_colorized_copy as pcopy

    ppc = port.cwipc_from_numpy_array(cloud, 3, device="cpu")
    got = pcopy(ppc)
    want = jcopy(jcwipc.cwipc_from_numpy_array(cloud, 3))
    assert got.get_numpy_array().tobytes() == want.get_numpy_array().tobytes()
    assert ppc.count() == len(cloud)  # the source stays alive
