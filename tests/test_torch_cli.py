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
* A CUDA default without a card raises CwipcError.  The flags that
  raised until their modules were ported run them: ``--lldplay`` and
  ``--mt-lldplay`` make sources that decode what the fake SIGNALS
  libraries hold, ``forward --lldpkg`` pushes to them,
  ``--interactive`` and ``--guided`` take the cloud that the ``w`` key
  selects in a scripted ``RegistrationVisualizer``, point for point the
  JAX registrator's over the same recording; ``register --plot`` saves
  its figure.
* ``view``, ``play`` and ``copy``: ``copy`` writes the JAX command's files
  byte for byte (single to single, stream to stream, ``--compress``) and
  refuses the same mixes; ``play`` renders the JAX command's images byte
  for byte (the numpy splat, headless); ``view --help_commands`` prints
  the JAX keymap; ``view --profile`` writes a Chrome trace.
* ``register --guided --guided_noviewer`` over scripted stdin: the
  conditions of the JAX tests (tests/test_scripts.py:447-485).
* ``register --no_aruco`` on a two-camera color target: the coarse
  stage's camera transforms within 1e-9 of the JAX register's.
"""

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch
from test_torch_gicp_flow import _scenes

import cwipc_util_tpu as jc
from cwipc_util_tpu.io.visualizer import HELP as J_HELP
import cwipc_util_tpu_torch as port
from cwipc_util_tpu.registration import util as jutil
from cwipc_util_tpu.scripts import cwipc_create_analysis_test as j_create
from cwipc_util_tpu.scripts import cwipc_register as j_register
from cwipc_util_tpu_torch import codec
from cwipc_util_tpu_torch import util as putil
from cwipc_util_tpu_torch.core.errors import CwipcError
from cwipc_util_tpu_torch.filters.simulatecams import SimulatecamsFilter
from cwipc_util_tpu_torch.models.synthetic import _generate_host
from cwipc_util_tpu_torch.registration.cameraconfig import CameraConfig, default_cameraconfig
from cwipc_util_tpu_torch.registration.util import cwipc_transform
from cwipc_util_tpu_torch.net import sink_lldpkg, source_lldplay
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
    assert listed[:5] == ["view", "grab", "play", "copy", "register"], rv.stderr
    assert listed[5:14] == ["analyze_registration", "create_analysis_test", "find_transform", "forward", "join",
                            "netserver", "test_aligner", "timing", "toproxy"], rv.stderr
    for special in ("help", "version", "check", "python", "parallel"):
        assert special in listed


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


def _encoded(pts, ts):
    enc = codec.cwipc_new_encoder(octree_bits=9)
    enc.feed(port.cwipc_from_numpy_array(pts, ts, device="cpu"))
    return enc.get_bytes()


def _tile_points(tile, n=2000, seed=0):
    rng = np.random.default_rng(seed + tile)
    pts = np.zeros(n, port.POINT_DTYPE)
    for f in ("x", "y", "z"):
        pts[f] = rng.uniform(-1, 1, n)
    pts["tile"] = tile
    return pts


def _drain_one(src, timeout=20):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if src.available(True):
            return src.get()
    return None


def _answer_w(monkeypatch):
    """The headless window sink answers ``w`` once it has drawn a frame."""
    from cwipc_util_tpu_torch.io import gl_render, visualizer_sink

    monkeypatch.setattr(gl_render, "gl_available", lambda: False)
    monkeypatch.setattr(visualizer_sink.cwipc_window_sink, "interact",
                        lambda win, prompt, responses, millis: "w" if win.get_image() is not None else "\0")


FLAGS = ["--lldplay", "--mt-lldplay", "forward --lldpkg", "--interactive", "--guided", "--plot"]


@pytest.mark.parametrize("flag", FLAGS)
def test_flags_of_the_viewer_dash_and_plot_run_their_modules(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SIGNALS_SMD_PATH", str(putil.build_fake_signals()))
    monkeypatch.setattr(sink_lldpkg, "_lldpkg_dll_reference", None)
    monkeypatch.setattr(source_lldplay, "_lldplay_dll_reference", None)
    url = str(tmp_path / "cdn") + "/"
    if flag in ("--lldplay", "--mt-lldplay"):
        tiles = (1,) if flag == "--lldplay" else (1, 2)
        sink = sink_lldpkg.cwipc_sink_lldpkg(url)
        for t in tiles:
            sink.add_stream(tilenum=t, tiledesc={"normal": {"x": 0.0, "y": 0.0, "z": float(t)}})
        sink.start()
        want = 0
        for i, t in enumerate(tiles):
            blob = _encoded(_tile_points(t), 777)
            dec = codec.cwipc_new_decoder(device="cpu")
            dec.feed(blob)
            want += dec.get().count()
            assert sink.feed(blob, i)
        sink.stop()
        src = _scriptsupport.activesource_factory_from_args(_args(flag, url, "--device", "cpu"))()
        assert src.start()
        pc = _drain_one(src)
        t_0 = time.time()
        src.stop()
        assert time.time() - t_0 < 3.0  # the tiles' decoders see the end at once (a 2 s join each before)
        assert pc is not None and pc._device.type == "cpu" and pc.timestamp() == 777 and pc.count() == want
        if flag == "--mt-lldplay":
            assert sorted(np.unique(pc.get_numpy_array()["tile"])) == [1, 2]
    elif flag == "forward --lldpkg":
        monkeypatch.setattr(sys, "argv", ["cwipc forward", "--lldpkg", url + "live.mpd", "--synthetic",
                                          "--npoints", "1000", "--count", "3", "--nodrop", "--device", "cpu"])
        assert cwipc_forward.main() == 0
        frames = sorted((tmp_path / "cdn").glob("s0_*.frame"))
        assert (tmp_path / "cdn" / "streams.txt").read_text().splitlines()[0].strip() == "1" and len(frames) == 3
        dec = codec.cwipc_new_decoder(device="cpu")
        dec.feed(frames[0].read_bytes())
        assert dec.get().count() > 0
    elif flag in ("--interactive", "--guided"):
        # both packages' registrators over the same 3 distinct frames: the
        # cloud that "w" selects is the JAX one's, point for point
        from cwipc_util_tpu.io import gl_render as jgl
        from cwipc_util_tpu.io import visualizer_sink as jvs
        from cwipc_util_tpu.scripts import _scriptsupport as j_support

        assert cwipc_register.RegistrationVisualizer is cwipc_register.RegistrationVisualizer
        _recording(str(tmp_path / "rec"))
        _answer_w(monkeypatch)
        monkeypatch.setattr(jgl, "gl_available", lambda: False)
        monkeypatch.setattr(jvs.cwipc_window_sink, "interact",
                            lambda win, prompt, responses, millis: "w" if win.get_image() is not None else "\0")
        captured = []
        for reg, support in ((cwipc_register.Registrator(_args(flag, "--playback", "rec", "--device", "cpu")),
                              _scriptsupport),
                             (j_register.Registrator(_args(flag, "--playback", "rec",
                                                           parser=j_support.ArgumentParser())), j_support)):
            reg.capturer = support.activesource_factory_from_args(reg.args)()
            assert reg.capturer.start()
            captured.append(reg.capture())
            reg.capturer.stop()
        pc, want = captured
        assert pc._device.type == "cpu" and pc.count() == want.count() == 3000
        assert pc.timestamp() == want.timestamp()
        assert pc.get_numpy_array().tobytes() == np.asarray(want.get_numpy_array()).tobytes()
    else:
        pts = np.zeros(64, port.POINT_DTYPE)
        pts["x"] = np.arange(64, dtype=np.float32) * 0.01
        pts["tile"] = np.repeat([1, 2], 32)
        # headless, the figure is saved as the JAX script saves it
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


_IMAGES = r"""
import hashlib
from cwipc_util_tpu_torch.io import visualizer_sink as _vs
_feed = _vs.cwipc_window_sink.feed
def _rec(self, pc, clear):
    rv = _feed(self, pc, clear)
    RECORDED.append(hashlib.sha1(self.get_image().tobytes()).hexdigest())
    return rv
_vs.cwipc_window_sink.feed = _rec
"""


def _recording(d, n=3, npoints=3000, seed=4):
    """n PLY frames named by their timestamps, from a seed."""
    rng = np.random.default_rng(seed)
    os.makedirs(d)
    for i in range(n):
        pts = np.zeros(npoints, port.POINT_DTYPE)
        for f in ("x", "y", "z"):
            pts[f] = rng.uniform(-1, 1, npoints)
        pts["y"] += 1.0
        for f in ("r", "g", "b"):
            pts[f] = rng.integers(0, 256, npoints)
        pts["tile"] = rng.choice(np.array([1, 2], np.uint8), npoints)
        port.cwipc_write(os.path.join(d, f"pointcloud-{1000 + 33 * i}.ply"),
                         port.cwipc_from_numpy_array(pts, 0, device="cpu"), port.CWIPC_FLAGS_BINARY)


def _tree(d):
    return {os.path.relpath(os.path.join(r, f), d): open(os.path.join(r, f), "rb").read()
            for r, _, fs in os.walk(d) for f in fs}


def test_view_play_and_copy_match_the_jax_commands(tmp_path, monkeypatch):
    """``copy`` single -> single, stream -> stream (``--cwipcdump`` and
    ``--compress``) writes the JAX command's files byte for byte and
    refuses the same mixes; ``play`` (headless, the numpy splat) renders
    the JAX command's images byte for byte; ``view --synthetic --nodisplay``
    and ``grab`` then ``play`` run (tests/test_scripts.py:68, :72);
    ``view --help_commands`` prints the JAX keymap; ``view --profile DIR``
    writes a Chrome trace."""
    from cwipc_util_tpu.io import gl_render as jgl
    from cwipc_util_tpu.io import visualizer_sink as jvs
    from cwipc_util_tpu.scripts import cwipc_copy as j_copy
    from cwipc_util_tpu.scripts import cwipc_play as j_play

    for side in ("port", "jax"):
        _recording(str(tmp_path / side / "rec"))
    src = "rec/pointcloud-1000.ply"
    copies = [(src, "one.cwipcdump"), ("--cwipcdump", "rec", "converted"), ("--compress", "rec", "compressed"),
              ("rec", "single.ply"), (src, "somedir"), (src, "out.CWIPCDUMP")]
    argv = []
    for args in copies:
        argv += ["copy", *args, "--device", "cpu", "--then"]
    argv += ["play", "rec", "--count", "3", "--fps", "10", "--device", "cpu", "--then",
             "view", "--synthetic", "--npoints", "1000", "--nodisplay", "--count", "5", "--device", "cpu", "--then",
             "grab", "--synthetic", "--npoints", "1000", "--count", "2", "grabbed", "--device", "cpu", "--then",
             "play", "grabbed", "--nodisplay", "--count", "2", "-v", "--device", "cpu", "--then",
             "view", "--help_commands", "--then",
             "view", "--profile", "prof", "--synthetic", "--npoints", "1000", "--nodisplay", "--count", "2",
             "--device", "cpu", "--then", "view", "--version"]
    os.makedirs(tmp_path / "port" / "grabbed")
    monkeypatch.setenv("CWIPC_GL", "0")
    proc = _cli_start(tmp_path / "port", *argv, prelude=_IMAGES)
    jcodes = [_jax_main(j_copy, tmp_path / "jax", monkeypatch, *args) for args in copies]
    images = []
    monkeypatch.setattr(jgl, "gl_available", lambda: False)
    feed = jvs.cwipc_window_sink.feed

    def recording_feed(win, pc, clear):
        rv = feed(win, pc, clear)
        images.append(hashlib.sha1(win.get_image().tobytes()).hexdigest())
        return rv

    monkeypatch.setattr(jvs.cwipc_window_sink, "feed", recording_feed)
    assert _jax_main(j_play, tmp_path / "jax", monkeypatch, "rec", "--count", "3", "--fps", "10") == 0
    rv = _cli_wait(proc)
    codes = [int(c) for c in re.findall(r"^=== exit (-?\d+)$", rv.stdout, re.M)]
    assert codes == jcodes + [0] * 7 and jcodes == [0, 0, 0, 1, 1, 1], (codes, rv.stderr[-1500:])
    for tree in ("one.cwipcdump", "converted", "compressed"):
        p, j = tmp_path / "port" / tree, tmp_path / "jax" / tree
        got, want = (_tree(p), _tree(j)) if p.is_dir() else (p.read_bytes(), j.read_bytes())
        assert got == want and len(got) > (2 if p.is_dir() else 32), tree
    assert len(_tree(tmp_path / "port" / "compressed")) == 3
    recorded = json.loads(rv.stderr.strip().splitlines()[-1][len("recorded "):])
    assert recorded == images and len(images) == 3 and len(set(images)) == 3
    outs = rv.stdout.split("=== exit")
    assert "Cannot convert stream input" in rv.stderr + rv.stdout
    assert len(os.listdir(tmp_path / "port" / "grabbed")) == 2 and "display_pointcount: count=2" in outs[9]
    assert J_HELP.strip() in outs[10] and "Pause/resume" in J_HELP
    assert json.loads((tmp_path / "port" / "prof" / "trace.json").read_text())["traceEvents"]
    assert outs[12].split()[-1] == jc.cwipc_get_version()


def _guided(cwd, answers):
    prelude = f"import io; sys.stdin = io.StringIO({answers!r})"
    return _cli_start(cwd, "create_analysis_test", "--ncamera", "2", "--npoints", "3000", "--translation", "0.02",
                      "testpc.ply", "--device", "cpu", "--then",
                      "register", "--guided", "--guided_noviewer", "--nograb", "testpc.ply", "--nocoarse",
                      "--nofloor", "--device", "cpu", prelude=prelude)


def test_register_guided_scripted(tmp_path):
    """``register --guided --guided_noviewer`` over stdin: accepting stores
    the fine matrices, rejecting leaves the cameraconfig at identity
    (tests/test_scripts.py:447, :467)."""
    for d in ("yes", "no"):
        os.makedirs(tmp_path / d)
    procs = {d: _guided(tmp_path / d, f"MultiCameraIterative\n{d}\nno\n") for d in ("yes", "no")}
    for d, proc in procs.items():
        rv = _cli_wait(proc)
        assert rv.returncode == 0 and rv.stdout.count("=== exit 0") == 2, rv.stderr[-1500:]
        assert "Fine alignment" in rv.stderr and "Multicamera alignment algorithm" in rv.stdout
        assert "Accept (yes/no/show)" in rv.stdout
        cfg = json.loads((tmp_path / d / "cameraconfig.json").read_text())
        identity = [np.allclose(np.array(cam["trafo"]), np.identity(4)) for cam in cfg["camera"]]
        assert len(identity) == 2 and all(identity) == (d == "no"), (d, identity)
