"""Slice parity: the port's command line (``python -m cwipc_util_tpu_torch``)
against the JAX package's, on the CPU.

Every port command runs in a subprocess where jax and the JAX package
cannot be imported (an import finder refuses them), through
``runpy.run_module`` as ``python -m`` runs it; the JAX commands run in this
process through their scripts' ``main``.  Tolerances:

* ``--version``, ``help`` and ``check``: the version printed equals the
  JAX package's; help lists only the ported commands; the self-check
  passes on the CPU.
* ``create_analysis_test`` on one input file (``--playback``): xyz
  allclose at rtol 1e-6 (atol 0), rgb and tiles equal, ground truth
  allclose at rtol 1e-12.
* ``register --device cpu --nograb --nocoarse --nofloor`` on the 10 cm
  polyhedron of tests/test_torch_gicp_flow.py, whose normals are all
  determined: every camera's trafo within 1e-5 m and 1e-5 rad of the JAX
  CLI's, the saved correspondence within 5 % relative.
* The recordings flow at 9,000 points: the conditions of the JAX test
  (tests/test_scripts.py:694-699), and 2 frames replayed fused.
* A CUDA default without a card raises CwipcError; so does each flag
  whose module is not ported (``--lldplay``, ``--mt-lldplay``,
  ``forward --lldpkg``, the viewer's); ``register --plot`` saves its
  figure.
* ``register --no_aruco`` on a two-camera color target: the coarse
  stage's camera transforms within 1e-9 of the JAX register's.
"""

import json
import os
import re
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch
from test_torch_gicp_flow import _scenes

import cwipc_util_tpu as jc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu.registration import util as jutil
from cwipc_util_tpu.scripts import cwipc_create_analysis_test as j_create
from cwipc_util_tpu.scripts import cwipc_register as j_register
from cwipc_util_tpu_torch.core.errors import CwipcError
from cwipc_util_tpu_torch.filters.simulatecams import SimulatecamsFilter
from cwipc_util_tpu_torch.models.synthetic import _generate_host
from cwipc_util_tpu_torch.registration.cameraconfig import CameraConfig, default_cameraconfig
from cwipc_util_tpu_torch.registration.util import cwipc_transform
from cwipc_util_tpu_torch.scripts import _scriptsupport, cwipc_forward, cwipc_register
from cwipc_util_tpu_torch.scripts.cwipc_create_analysis_test import perturbation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HARNESS = r"""
import importlib.abc, json, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cwipc_util_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
RECORDED = []
exec(sys.argv[2])
module, commands = sys.argv[1], [[]]
for arg in sys.argv[3:]:
    if arg == "--then":
        commands.append([])
    else:
        commands[-1].append(arg)
status = 0
try:
    for argv in commands:
        sys.argv = [module] + argv
        if len(commands) == 1:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
            continue
        try:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
            code = 0
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else int(e.code is not None)
        print(f"=== exit {code}", flush=True)
        status = status or code
finally:
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cwipc_util_tpu")]
    print("imported", leaked, file=sys.stderr)
    print("recorded", json.dumps(RECORDED), file=sys.stderr)
sys.exit(status)
"""


def _cli_start(cwd, *args, module="cwipc_util_tpu_torch", prelude=""):
    """Start one port command in a jax-less subprocess, run as ``python -m
    module`` runs it; ``--then`` separates further commands run one after
    another in the same process, each followed by a line ``=== exit N``
    (a command that raises ends the run).  ``prelude`` runs first and may
    append to ``RECORDED``, printed as JSON on a last ``recorded`` line of
    stderr.  It gets 2 threads: beside the other test workers, more threads
    than that spin on a full machine (the recordings flow took over 240 s so under Tier-1, ~45 s
    with 2 threads beside six busy processes)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env.update(OMP_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", _HARNESS, module, prelude, *args], cwd=str(cwd), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _cli_wait(proc, timeout=600):
    """The finished command: returncode, stdout, stderr."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    rv = subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr)
    assert "imported []" in rv.stderr, rv.stderr[-2000:]
    return rv


def _cli(cwd, *args, timeout=600):
    """One port command in a jax-less subprocess, run to its end."""
    return _cli_wait(_cli_start(cwd, *args), timeout)


def _jax_main(module, cwd, monkeypatch, *args):
    """One JAX command in this process, through its script's main()."""
    with monkeypatch.context() as m:
        m.chdir(cwd)
        m.setattr(sys, "argv", ["cwipc", *args])
        return module.main()


def _overall(stdout):
    return [float(v) for v in re.findall(r"overall correspondence (\d+\.\d+)", stdout)]


def test_version_help_and_check(tmp_path):
    procs = [_cli_start(tmp_path, *args) for args in (("--version",), ("help",), ("check", "--device", "cpu"))]
    rv = _cli_wait(procs[0])
    assert rv.returncode == 0, rv.stderr[-1500:]
    assert rv.stdout.strip() == jc.cwipc_get_version() == port.cwipc_get_version()
    rv = _cli_wait(procs[2])
    assert rv.returncode == 0, rv.stderr[-1500:]
    assert "check: all ok" in rv.stdout and "capturer kinect: not installed" in rv.stdout
    rv = _cli_wait(procs[1])
    assert rv.returncode == 1  # as the JAX dispatcher's help
    listed = re.findall(r"^  (\w+) +- ", rv.stderr, re.M)
    assert listed[:2] == ["grab", "register"], rv.stderr
    assert listed[2:11] == ["analyze_registration", "create_analysis_test", "find_transform", "forward", "join",
                            "netserver", "test_aligner", "timing", "toproxy"], rv.stderr
    for special in ("help", "version", "check", "python", "parallel"):
        assert special in listed
    assert not {"view", "play", "copy"} & set(listed)


def test_create_analysis_test_equals_the_jax_script(tmp_path, monkeypatch):
    body = port.cwipc_from_numpy_array(_generate_host(95, 95, 0.5), 0, device="cpu")
    port.cwipc_write(str(tmp_path / "body.ply"), body, port.CWIPC_FLAGS_BINARY)
    args = ("--ncamera", "3", "--noise", "0.002", "--translation", "0.03", "--rotation", "0.06",
            "--playback", "body.ply")
    proc = _cli_start(tmp_path, "create_analysis_test", "--device", "cpu", *args, "port.ply")
    assert _jax_main(j_create, tmp_path, monkeypatch, *args, "jax.ply") == 0  # while the port's runs
    rv = _cli_wait(proc)
    assert rv.returncode == 0, rv.stderr[-1500:]
    got = port.cwipc_read(str(tmp_path / "port.ply"), 0, device="cpu").get_numpy_array()
    want = jc.cwipc_read(str(tmp_path / "jax.ply"), 0).get_numpy_array()
    assert len(got) == len(want) > 8000
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-6, atol=0)
    for f in ("r", "g", "b", "tile"):
        np.testing.assert_array_equal(got[f], want[f])
    gt_p = json.loads((tmp_path / "port.ply.gt.json").read_text())
    gt_j = json.loads((tmp_path / "jax.ply.gt.json").read_text())
    assert gt_p.keys() == gt_j.keys() == {"1", "2", "4"}
    for k in gt_j:
        np.testing.assert_allclose(gt_p[k], gt_j[k], rtol=1e-12)


def test_register_polyhedron_matches_the_jax_cli(tmp_path, monkeypatch):
    j_scene, _ = _scenes(0.1, 4, 0.01)
    jc.cwipc_write(str(tmp_path / "scene.ply"), j_scene, jc.CWIPC_FLAGS_BINARY)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    args = ("--nograb", "../scene.ply", "--nocoarse", "--nofloor")
    proc = _cli_start(tmp_path / "port", "register", "--device", "cpu", *args)
    assert _jax_main(j_register, tmp_path / "jax", monkeypatch, *args) == 0  # while the port's runs
    rv = _cli_wait(proc)
    assert rv.returncode == 0, rv.stderr[-1500:]
    got = json.loads((tmp_path / "port" / "cameraconfig.json").read_text())
    want = json.loads((tmp_path / "jax" / "cameraconfig.json").read_text())
    assert len(got["camera"]) == len(want["camera"]) == 3
    for cp, cj in zip(got["camera"], want["camera"], strict=True):
        dt, dr = jutil.transformation_compare(np.asarray(cj["trafo"]), np.asarray(cp["trafo"]))
        assert dt <= 1e-5 and dr <= 1e-5, (dt, dr)
    np.testing.assert_allclose(got["correspondence"], want["correspondence"], rtol=0.05)
    before, after = _overall(rv.stdout)[0], _overall(rv.stdout)[-1]
    assert after < before / 3


def test_recordings_flow_registers_and_replays_fused(tmp_path):
    pc = port.cwipc_from_numpy_array(_generate_host(94, 94, 0.0), 0, device="cpu")
    pc = SimulatecamsFilter(3, hard=False, seed=5).filter(pc)
    counts = []
    for cam in range(3):
        tile_pc = port.cwipc_tilefilter(pc, 1 << cam)
        moved = cwipc_transform(tile_pc, perturbation(100 + cam, 0.03, 0.06))
        counts.append(moved.count())
        port.cwipc_write(str(tmp_path / f"camera{cam}.ply"), moved)
    assert sum(counts) == 94 * 94
    rv = _cli(ROOT, "register", "--device", "cpu", "--nocoarse", "--nofloor", str(tmp_path))
    assert rv.returncode == 0, rv.stderr[-1500:]
    overall = _overall(rv.stdout)
    assert len(overall) >= 2
    assert overall[-1] < overall[0] / 3, overall
    cfg = json.loads((tmp_path / "cameraconfig.json").read_text())
    assert cfg["type"] == "playback" and len(cfg["camera"]) == 3
    trafos = [np.array(c["trafo"]) for c in cfg["camera"]]
    assert any(not np.allclose(T, np.identity(4)) for T in trafos)
    # the aligned recording replays, looped as --loop asks, as one fused
    # stream: each camera's points under its trafo and its camera mask
    cfg.update(loop=True, _config_dir=str(tmp_path))
    cap = port.cwipc_capturer(json.dumps(cfg), device="cpu")
    assert cap.start()
    for _ in range(2):
        assert cap.available(True)
        fused = cap.get()
        arr = fused.get_numpy_array()
        assert [int((arr["tile"] == 1 << cam).sum()) for cam in range(3)] == counts
        assert fused.count() == sum(counts)
    cap.stop()


def _args(*argv, parser=None):
    parser = parser or _scriptsupport.ArgumentParser()
    for flag in ("--guided", "--interactive", "--guided_noviewer", "--tabletop", "--no_aruco", "--plot",
                 "--nograb", "--skip", "--coarse", "--nocoarse"):
        parser.add_argument(flag, action="store_true" if flag not in ("--nograb", "--skip") else "store")
    for name in ("algorithm_analyzer", "algorithm_multicamera", "algorithm_aligner", "correspondence"):
        parser.add_argument(f"--{name}")
    return parser.parse_args(argv)


def test_cuda_default_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args("--synthetic")
    assert args.device == "cuda"
    with pytest.raises(CwipcError, match="CUDA"):
        _scriptsupport.beginOfRun(args)
    with pytest.raises(CwipcError, match="CUDA"):
        _scriptsupport.activesource_factory_from_args(args)
    args = _args("--synthetic", "--device", "cpu")
    _scriptsupport.beginOfRun(args)
    src = _scriptsupport.activesource_factory_from_args(args)()
    src.start()
    assert src.get()._device.type == "cpu"
    src.stop()


def test_flags_of_unported_modules_raise(tmp_path, monkeypatch):
    for flag in ("--lldplay", "--mt-lldplay"):
        with pytest.raises(CwipcError, match="net/source_lldplay.py"):
            _scriptsupport.activesource_factory_from_args(_args(flag, "x", "--device", "cpu"))
    monkeypatch.setattr(sys, "argv", ["cwipc forward", "--lldpkg", "http://localhost/x", "--synthetic",
                                      "--device", "cpu"])
    with pytest.raises(CwipcError, match="net/sink_lldpkg.py"):
        cwipc_forward.main()
    for flag in ("--interactive", "--guided"):
        reg = cwipc_register.Registrator(_args(flag, "--device", "cpu"))
        with pytest.raises(CwipcError, match="io/visualizer.py"):
            reg.interactive_capture()
    pts = np.zeros(64, port.POINT_DTYPE)
    pts["x"] = np.arange(64, dtype=np.float32) * 0.01
    pts["tile"] = np.repeat([1, 2], 32)
    # --plot is ported: headless, the figure is saved as the JAX script saves it
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    reg = cwipc_register.Registrator(_args("--plot", "--device", "cpu"))
    reg.cameraconfig = CameraConfig("unused.json")
    reg.cameraconfig.load(json.dumps(default_cameraconfig("synthetic", ["a", "b"])).encode())
    assert reg.check_alignment(port.cwipc_from_numpy_array(pts, 0, device="cpu"), "before") >= 0
    assert (tmp_path / "registration_analysis.png").stat().st_size > 1000


def test_register_no_aruco_matches_jax():
    """``register --no_aruco`` runs the automated color-target detector, as
    the JAX script does: on the two-camera color-target scene the coarse
    stage's camera transforms equal the JAX register's within 1e-9."""
    from cwipc_util_tpu.scripts import _scriptsupport as j_scriptsupport

    from test_torch_coarse import color_target_scene

    m = color_target_scene()
    got = {}
    for name, reg, pc in (
            ("port", cwipc_register.Registrator(_args("--no_aruco", "--device", "cpu")),
             port.cwipc_from_numpy_matrix(m, 0, device="cpu")),
            ("jax", j_register.Registrator(_args("--no_aruco", parser=j_scriptsupport.ArgumentParser())),
             jc.cwipc_from_numpy_matrix(m, 0))):
        reg.cameraconfig = (CameraConfig if name == "port" else j_register.CameraConfig)("unused.json")
        reg.cameraconfig.load(json.dumps(default_cameraconfig("synthetic", ["a", "b"])).encode())
        assert reg.coarse_registration(pc), f"{name}: the color target was not found"
        got[name] = [np.asarray(reg.cameraconfig.get_transform(i).get_matrix()) for i in range(2)]
    assert not np.allclose(got["port"][0], np.identity(4))
    for T, Tj in zip(got["port"], got["jax"], strict=True):
        np.testing.assert_allclose(T, Tj, rtol=0, atol=1e-9)


def test_source_server_grabs_through_filters():
    """SourceServer: the grab loop feeds --count clouds through the --filter
    chain to its viewer, on the factory's device."""
    args = _args("--synthetic", "--npoints", "4000", "--count", "3", "--filter", "voxelize(0.05)",
                 "--device", "cpu")
    fed = []

    class Viewer:
        def feed(self, pc):
            fed.append(pc)

    grabber = _scriptsupport.activesource_factory_from_args(args)()
    server = _scriptsupport.SourceServer(grabber, Viewer(), args)
    server.run()
    server.stop()
    assert len(fed) == 3
    for pc in fed:
        assert pc._device.type == "cpu" and 0 < pc.count() < 4000 and pc.cellsize() >= 0.05
