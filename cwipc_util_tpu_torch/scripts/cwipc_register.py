"""cwipc register: the full camera calibration orchestrator.

The port of cwipc_util_tpu/scripts/cwipc_register.py.  Captures, files
and the registration run on ``--device`` (default CUDA): the fine
alignment's nearest neighbours on kernel 5 and its tile cuts on kernel 3.
``--interactive`` (and ``--guided`` without ``--guided_noviewer``)
captures through the port's viewer, ``RegistrationVisualizer``: its
``w`` key selects the cloud on display.  The guided "show" opens the
cloud in ``show_pointcloud``.  ``--no_aruco`` and ``--tabletop`` run the
automated color-target detector.

Re-implementation of the reference's register script
(reference: python/cwipc/scripts/cwipc_register.py:61-685): create or load a
cameraconfig, run coarse (fiducial) registration when the matrices are
identity or --coarse is given, align the floor, run fine multicamera
alignment, and save the matrices plus the measured correspondence.

Depth-of-flow parity with the reference:
- per-stage alignment analysis printout (check_alignment, reference :637-663)
  before and after every registration stage, stored as "correspondence" in
  the cameraconfig;
- --guided interactive walkthrough with stage banners, algorithm selection
  and an accept/reject/show loop after fine alignment (reference :243-351,
  :552-559, :609-625);
- recordings flow: a positional recording directory gets a generated
  cameraconfig (reference initialize_recording, :376-439);
- capturer-open error recovery: regenerate the cameraconfig via the auto
  factory and retry (reference :194-203);
- --nograb FILE registers a captured file without a live capturer,
  --interactive captures through the viewer's 'w' key (reference :477-518),
  --skip, --dry-run, --algorithm_* selection by class name.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np

from .. import cwipc_read, cwipc_read_debugdump, cwipc_write
from ..core.errors import CwipcError
from ..registration import analyze as analyze_mod
from ..registration import coarse as coarse_mod
from ..registration import fine as fine_mod
from ..registration import multicamera as multicam_mod
from ..registration.cameraconfig import CameraConfig, default_cameraconfig
from ..registration.util import get_tiles_used, transformation_identity
from ..core.buffers import resolve_device
from ._scriptsupport import (
    ArgumentParser,
    activesource_factory_from_args,
    beginOfRun,
    endOfRun,
)

DEFAULT_FILENAME = "cameraconfig.json"


def _make_registration_visualizer_class():
    # Lazy base import: the viewer stack (cv2/GL) must not load for
    # headless register runs that never go interactive.
    from ..io.visualizer import Visualizer

    class RegistrationVisualizer(Visualizer):
        """Viewer variant for interactive capture: the 'w' key selects the
        current cloud instead of writing a file, and cameraconfig reloads
        go through the registrator (reference: cwipc_register.py:41-59)."""

        captured_pc = None
        reload_cameraconfig_callback = None

        def write_current_pointcloud(self):
            if self.current_pc is not None:
                self.captured_pc = self.current_pc.clone()
                self.stopped = True

        def reload_cameraconfig(self):
            if self.reload_cameraconfig_callback:
                self.reload_cameraconfig_callback()
            super().reload_cameraconfig()

    return RegistrationVisualizer


def __getattr__(name):
    # module-level lazy attribute (PEP 562): RegistrationVisualizer is part
    # of the reference module surface but must not import the viewer stack
    # until requested.  Cached in globals() so every access returns the SAME
    # class object (isinstance/subclass checks across accesses must hold).
    if name == "RegistrationVisualizer":
        cls = _make_registration_visualizer_class()
        globals()[name] = cls
        return cls
    raise AttributeError(name)


class Registrator:
    def __init__(self, args):
        self.args = args
        self.verbose = args.verbose > 0
        self.device = resolve_device(args.device)
        self.dry_run = getattr(args, "dry_run", False)
        self.cameraconfig: Optional[CameraConfig] = None
        self.capturer = None
        self.proposed_cellsize = 0.0
        if self.args.guided:
            self.args.interactive = True
        # algorithm selection by class name (reference :85-95,149-152)
        self.analyzer_class = self._resolve(
            analyze_mod, args.algorithm_analyzer, analyze_mod.DEFAULT_ANALYZER_ALGORITHM
        )
        self.multicamera_class = self._resolve(
            multicam_mod, args.algorithm_multicamera,
            multicam_mod.DEFAULT_MULTICAMERA_ALGORITHM,
        )
        self.aligner_class = self._resolve(
            fine_mod, args.algorithm_aligner, fine_mod.DEFAULT_FINE_ALIGNMENT_ALGORITHM
        )

    @staticmethod
    def _resolve(module, name: Optional[str], default):
        if not name:
            return default
        cls = getattr(module, name, None)
        if cls is None:
            raise CwipcError(f"register: unknown algorithm {name!r} in {module.__name__}")
        return cls

    # -- user interaction -------------------------------------------------------

    def prompt(self, message: str) -> None:
        print(message, flush=True)

    def ask(self, prompt: str, default: str) -> str:
        """Stdin question with a default (reference :173-181); scripted runs
        pipe answers in."""
        sys.stdout.write(f"{prompt} [{default}] ? ")
        sys.stdout.flush()
        line = sys.stdin.readline().strip()
        return line or default

    def banner(self, *lines: str) -> None:
        print("=" * 60, file=sys.stderr)
        for line in lines:
            print(f"===== {line}", file=sys.stderr)
        print("=" * 60, file=sys.stderr)

    # -- capture ---------------------------------------------------------------

    def open_capturer(self) -> bool:
        # Registration captures repeatedly (coarse, floor, fine, verify) —
        # a finite recording must replay as a live-camera stand-in, so the
        # register flow opts into looping playback explicitly (plain
        # conversion flows keep the reference's no-loop default).
        if getattr(self.args, "loop", None) is False:
            self.args.loop = True
        factory = activesource_factory_from_args(self.args, autoConfig=False)
        try:
            self.capturer = factory()
        except (CwipcError, RuntimeError) as e:
            if self.verbose:
                print(f"register: cannot open capturer: {e}")
            self.capturer = None
            return False
        for want in ("rgb", "depth", "timestamps"):
            try:
                self.capturer.request_metadata(want)
            except Exception:
                pass
        return bool(self.capturer.start())

    def create_cameraconfig_via_auto(self) -> bool:
        """Recovery path: open with auto-config and save its defaults
        (reference create_cameraconfig, :456-472)."""
        try:
            tmp = activesource_factory_from_args(self.args, autoConfig=True)()
            tmp.start()
            config = tmp.get_config()
            tmp.stop()
        except Exception as e:
            print(f"register: auto-config probe failed: {e}")
            return False
        if not config or config == b"{}":
            return False
        self.cameraconfig.load(config)
        if not self.dry_run:
            self.cameraconfig.save()
            if self.verbose:
                print(f"register: created {self.cameraconfig.filename}")
        return True

    def create_cameraconfig(self) -> None:
        """Reference-parity name (reference: cwipc_register.py:456-472):
        probe with auto-config and save the capturer's defaults."""
        if not self.create_cameraconfig_via_auto():
            raise RuntimeError("Cannot get cameraconfig")

    def create_nograb_cameraconfig(self) -> None:
        """--nograb runs read the cameraconfig.json next to the input
        (reference: cwipc_register.py:474-475)."""
        if self.cameraconfig is None:
            self.cameraconfig = CameraConfig(DEFAULT_FILENAME)
        with open(DEFAULT_FILENAME, "rb") as fp:
            self.cameraconfig.load(fp.read())

    def _capture_some_frames(self, count: int = 2) -> None:
        """Warm up so get_config() reflects all parameters (reference :665-681)."""
        got = 0
        while got < count and not self.capturer.eof():
            if not self.capturer.available(True):
                continue
            pc = self.capturer.get()
            if pc is not None:
                pc.free()
                got += 1

    def capture(self):
        """One registration capture: --nograb file, --skip N discards,
        --interactive viewer-driven, else next frame (reference :477-497)."""
        if self.args.nograb:
            if self.args.nograb.endswith(".cwipcdump"):
                return cwipc_read_debugdump(self.args.nograb, self.device)
            return cwipc_read(self.args.nograb, 0, self.device)
        if self.args.skip:
            if self.verbose:
                print(f"register: skipping {self.args.skip} captures")
            for _ in range(self.args.skip):
                if self.capturer.available(True):
                    pc = self.capturer.get()
                    if pc is not None:
                        pc.free()
        if self.args.interactive and not self.args.guided_noviewer:
            return self.interactive_capture()
        deadline = time.time() + 30
        while time.time() < deadline:
            if not self.capturer.available(True):
                continue
            pc = self.capturer.get()
            if pc is not None and pc.count() > 0:
                return pc
        raise CwipcError("register: could not capture a pointcloud")

    def interactive_capture(self):
        """Show the live stream; the 'w' key selects the capture
        (reference RegistrationVisualizer + interactive_capture, :44-59,:499-518)."""
        import threading

        from ._scriptsupport import SourceServer

        RegistrationVisualizer = _make_registration_visualizer_class()
        visualizer = RegistrationVisualizer(
            self.verbose, title="cwipc_register", args=self.args
        )
        visualizer.reload_cameraconfig_callback = self._reload_cameraconfig_from_file
        server = SourceServer(self.capturer, visualizer, self.args, owns_grabber=False)
        thread = threading.Thread(target=server.run, name="cwipc_register.SourceServer")
        visualizer.set_producer(thread)
        visualizer.set_source(self.capturer)
        thread.start()
        visualizer.run()
        server.stop()
        thread.join()
        if visualizer.captured_pc is None:
            print("register: no capture selected in interactive mode. Exiting.")
            sys.exit(1)
        return visualizer.captured_pc

    # -- config -----------------------------------------------------------------

    def load_cameraconfig(self) -> None:
        filename = self.args.cameraconfig or DEFAULT_FILENAME
        if filename == "auto":
            filename = DEFAULT_FILENAME
        self.cameraconfig = CameraConfig(filename)
        if os.path.exists(filename):
            self.cameraconfig.load()
            return
        config_bytes = None
        if self.capturer is not None:
            try:
                config_bytes = self.capturer.get_config()
            except Exception:
                config_bytes = None
        if config_bytes:
            self.cameraconfig.load(config_bytes)
        else:
            ncam = self._guess_camera_count()
            data = default_cameraconfig("synthetic", [str(i) for i in range(ncam)])
            self.cameraconfig.load(json.dumps(data).encode("utf8"))

    def _guess_camera_count(self) -> int:
        if self.capturer is not None:
            return max(1, self.capturer.maxtile() - 1)
        if self.args.nograb:
            pc = self.capture()
            try:
                return max(1, len(get_tiles_used(pc)))
            finally:
                pc.free()
        return 1

    def _reload_cameraconfig_from_file(self) -> None:
        print(f"register: reload cameraconfig from {self.cameraconfig.filename}")
        if os.path.exists(self.cameraconfig.filename):
            self.cameraconfig.load()

    def _reload_cameraconfig_to_capturer(self) -> None:
        """Push new matrices to the capturer: close and reopen (the robust
        route, reference :364-374); fall back to reload_config."""
        if self.capturer is None:
            return
        try:
            self.capturer.stop()
        except Exception:
            pass
        self.capturer = None
        if not self.open_capturer():
            raise CwipcError("register: cannot reopen capturer after config change")

    def initialize_recording(self) -> bool:
        """Generate a cameraconfig for a recordings directory
        (reference :376-439; our playback recordings are ply/cwipcdump
        sequences, with the reference's mkv/bag types recognized for
        dispatch to external capturers)."""
        if os.path.exists(self.args.cameraconfig):
            return True
        kinds = {"ply": [], "dump": [], "mkv": [], "bag": []}
        for fn in sorted(os.listdir(self.args.recording)):
            if fn.startswith("."):
                continue
            low = fn.lower()
            if low.endswith(".ply"):
                kinds["ply"].append(fn)
            elif low.endswith(".cwipcdump"):
                kinds["dump"].append(fn)
            elif low.endswith(".mkv"):
                kinds["mkv"].append(fn)
            elif low.endswith(".bag"):
                kinds["bag"].append(fn)
        present = [k for k, v in kinds.items() if v]
        if len(present) == 0:
            print(f"register: {self.args.recording} contains no recordings "
                  "(.ply/.cwipcdump/.mkv/.bag)")
            return False
        if len(present) > 1:
            print(f"register: {self.args.recording} mixes recording types: {present}")
            return False
        kind = present[0]
        camtype = {"ply": "playback", "dump": "playback",
                   "mkv": "kinect_playback", "bag": "realsense_playback"}[kind]
        camera = [dict(filename=fn, type=camtype) for fn in kinds[kind]]
        cameraconfig = dict(version=3, type=camtype, system=dict(), camera=camera)
        with open(self.args.cameraconfig, "w") as fp:
            json.dump(cameraconfig, fp, indent=4)
        if self.verbose:
            print(f"register: created {self.args.cameraconfig}")
        return True

    # -- analysis ----------------------------------------------------------------

    def check_alignment(self, pc, label: str) -> float:
        """Per-camera alignment analysis printout (reference :637-663):
        every camera tile against all others, mode correspondence."""
        all_results = []
        cam_count = self.cameraconfig.camera_count()
        start = time.time()
        for cam_index in range(cam_count):
            targettile = 1 << cam_index
            othertile = 255 - targettile
            analyzer = self.analyzer_class()
            analyzer.set_source_pointcloud(pc, targettile)
            analyzer.set_reference_pointcloud(pc, othertile)
            analyzer.set_correspondence_measure("mode")
            analyzer.run()
            all_results.append(analyzer.get_results())
        duration = time.time() - start
        print(f"register: alignment {label} (analyzer ran {duration:.3f}s):")
        correspondences = []
        for cam_index, result in enumerate(all_results):
            print(
                f"register:   camera {cam_index} (tile {1 << cam_index}): "
                f"correspondence={result.minCorrespondence:.5f} "
                f"count={result.minCorrespondenceCount}"
            )
            correspondences.append(result.minCorrespondence)
        best = max(correspondences) if correspondences else 0.0
        print(f"register: alignment {label}: overall correspondence {best:.5f}")
        if self.args.plot:
            from ..registration.plot import plot_analysis_results

            plot_analysis_results(all_results, title=f"Alignment {label}")
        return best

    # -- stages -------------------------------------------------------------------

    def coarse_registration(self, pc) -> bool:
        algo_cls = (
            coarse_mod.MultiCameraCoarseColorTarget
            if self.args.tabletop or self.args.no_aruco
            else coarse_mod.MultiCameraCoarseAruco
        )
        print(f"register: coarse alignment class {algo_cls.__name__}")
        algo = algo_cls()
        algo.verbose = self.args.verbose > 2
        algo.set_tiled_pointcloud(pc)
        try:
            algo.set_serial_dict(self.cameraconfig.get_serial_dict())
        except Exception:
            pass
        start = time.time()
        ok = algo.run()
        if self.verbose:
            print(f"register: coarse aligner ran for {time.time() - start:.3f}s")
        if not ok:
            return False
        for i, T in enumerate(algo.get_result_transformations()):
            if i < self.cameraconfig.camera_count():
                old = self.cameraconfig.get_transform(i).get_matrix()
                self.cameraconfig.set_transform(i, np.asarray(T) @ old)
        return True

    def _run_multicam(self, pc, multicam_cls, aligner_cls, analyzer_cls,
                      label: str) -> bool:
        """Shared fine/floor runner with before/after analysis and result
        matrices stored wholesale (reference fine_registration, :561-635)."""
        if self.cameraconfig.camera_count() > 1:
            self.check_alignment(pc, f"before {label}")
        print(f"register: fine multicamera alignment using {multicam_cls.__name__} "
              f"(aligner {aligner_cls.__name__})")
        algo = multicam_cls()
        algo.verbose = self.args.verbose > 2
        algo.set_aligner_class(aligner_cls)
        if analyzer_cls is not None:
            try:
                algo.set_analyzer_class(analyzer_cls)
            except Exception:
                pass
        if self.args.correspondence:
            algo.set_max_correspondence(self.args.correspondence)
            print(f"register: override max correspondence to {self.args.correspondence}")
        algo.set_tiled_pointcloud(pc)
        for cam_index in range(self.cameraconfig.camera_count()):
            algo.set_original_transform(
                cam_index, self.cameraconfig.get_transform(cam_index).get_matrix()
            )
        start = time.time()
        ok = algo.run()
        if self.verbose:
            print(f"register: {label} ran for {time.time() - start:.3f}s")
        if not ok:
            print(f"register: could not do {label}")
            return False
        print(algo.report_change())
        new_pc = algo.get_result_pointcloud_full()
        try:
            correspondence = 0.0
            if self.cameraconfig.camera_count() > 1:
                correspondence = self.check_alignment(new_pc, f"after {label}")
            if self.args.guided:
                while True:
                    answer = self.ask("Accept (yes/no/show)", "yes")
                    if answer == "yes":
                        break
                    if answer == "no":
                        return False
                    if answer == "show":
                        try:
                            from ..registration.util import show_pointcloud

                            show_pointcloud(f"Result after {label}", new_pc)
                        except Exception as e:
                            print(f"register: cannot show: {e}")
        finally:
            # one full merged cloud per stage otherwise accumulates across
            # guided-mode passes
            new_pc.free()
        for i, T in enumerate(algo.get_result_transformations()):
            if i < self.cameraconfig.camera_count():
                self.cameraconfig.set_transform(i, np.asarray(T))
        if correspondence:
            self.cameraconfig.set_entry_from_string(f"correspondence={correspondence}")
        if getattr(algo, "proposed_cellsize", 0.0):
            self.proposed_cellsize = algo.proposed_cellsize
        return True

    def floor_registration(self, pc) -> bool:
        return self._run_multicam(
            pc,
            multicam_mod.MultiCameraToFloor,
            fine_mod.RegistrationComputer_ICP_Point2Point,
            analyze_mod.RegistrationAnalyzer,
            "floor alignment",
        )

    def ask_aligner_class(self, default):
        """Guided algorithm choice (reference :552-559)."""
        names = [
            "MultiCameraOneToAllOthers", "MultiCameraToFloor",
            "MultiCameraIterative", "MultiCameraIterativeInteractive",
        ]
        answer = self.ask(
            f"Multicamera alignment algorithm (None / {' / '.join(names)})",
            default.__name__,
        )
        if answer == "None":
            return None
        cls = getattr(multicam_mod, answer, None)
        if cls is None:
            print(f"register: unknown algorithm {answer!r}, using {default.__name__}")
            return default
        return cls

    def fine_registration(self, pc) -> bool:
        multicam_cls = self.multicamera_class
        if self.args.guided:
            multicam_cls = self.ask_aligner_class(multicam_cls)
            if multicam_cls is None:
                print("register: skipping fine registration")
                return False
        return self._run_multicam(
            pc, multicam_cls, self.aligner_class, self.analyzer_class,
            f"{multicam_cls.__name__} registration",
        )

    # -- main -------------------------------------------------------------------------

    def run(self) -> int:
        if self.args.recording:
            if self.args.cameraconfig:
                print("register: cannot use --cameraconfig with a recording")
                return 1
            self.args.cameraconfig = os.path.realpath(
                os.path.join(self.args.recording, DEFAULT_FILENAME)
            )
            if not self.initialize_recording():
                return 1
            self.args.playback = self.args.recording
            self.args.nodrop = True
            if self.args.guided:
                print("register: --guided implies --paused and --nodrop for recordings")
                self.args.paused = True

        if not self.args.nograb:
            if not self.open_capturer():
                if self.args.recording:
                    print(f"register: cannot open recording capturer, check "
                          f"{self.args.cameraconfig}")
                    return 1
                print("register: cannot open capturer; trying to create a cameraconfig")
                self.load_cameraconfig()
                if not self.create_cameraconfig_via_auto() or not self.open_capturer():
                    print("register: still cannot open capturer. Giving up.")
                    return 1
            self._capture_some_frames()
        self.load_cameraconfig()

        changed = False
        for override in self.args.conf_init or []:
            self.cameraconfig.set_entry_from_string(override)
            changed = True
        if not self.dry_run and (changed or not os.path.exists(self.cameraconfig.filename)):
            self.cameraconfig.save()
        if self.args.noregister:
            print(f"register: wrote {self.cameraconfig.filename} (no registration)")
            return 0
        if changed and self.capturer is not None:
            self._reload_cameraconfig_to_capturer()

        if self.args.tabletop and self.cameraconfig.camera_count() == 1:
            self.cameraconfig.set_transform(0, transformation_identity())
            if not self.dry_run:
                self.cameraconfig.save()
            print("register: tabletop single-camera setup saved")
            return 0

        # --coarse with existing matrices: reset to identity first (ref :234-241)
        if self.args.coarse and not self.cameraconfig.all_identity():
            print("register: reset matrices")
            for i in range(self.cameraconfig.camera_count()):
                self.cameraconfig.set_transform(i, transformation_identity())
            if not self.dry_run:
                self.cameraconfig.save()
            if self.capturer is not None:
                self._reload_cameraconfig_to_capturer()

        want_coarse = (self.args.coarse or self.cameraconfig.all_identity()) \
            and not self.args.nocoarse
        if want_coarse:
            if self.args.guided:
                self.banner(
                    "Coarse registration.",
                    "Place the fiducial (aruco) marker at the origin.",
                    "Make sure every camera can see the marker.",
                    "Adjust exposure/gain in cameraconfig.json if colors are off;",
                    "press c in the viewer to reload it.",
                    "Press w in the viewer to capture, q when done.",
                )
            self.prompt("Coarse registration: capturing aruco/color target")
            pc = self.capture()
            if self.coarse_registration(pc):
                print("register: coarse registration done")
                if not self.dry_run:
                    self.cameraconfig.save()
                if self.capturer is not None:
                    self._reload_cameraconfig_to_capturer()
            else:
                print("register: coarse registration failed (continuing)")
            pc.free()
        elif self.verbose:
            print("register: skipping coarse registration, matrices already set")

        if not self.args.nofloor:
            if self.args.guided:
                self.banner(
                    "Floor alignment.",
                    "Capture plenty of floor so it can be aligned to Y=0.",
                    "Use height_min/height_max in cameraconfig.json to include it.",
                    "Press w in the viewer to capture.",
                )
            self.prompt("Floor registration: capturing some floor")
            pc = self.capture()
            if self.floor_registration(pc):
                print("register: floor alignment done")
                if not self.dry_run:
                    self.cameraconfig.save()
                if self.capturer is not None:
                    self._reload_cameraconfig_to_capturer()
            pc.free()

        if self.cameraconfig.camera_count() > 1 and not self.args.nofine:
            while True:
                if self.args.guided:
                    self.banner(
                        "Fine alignment.",
                        "Have a person (or object) stand at the origin,",
                        "fully visible to all cameras.",
                        "Press w in the viewer to capture (or t for timelapse).",
                        "Press q if you are already happy with the registration.",
                    )
                self.prompt("Fine registration: capturing human-sized object")
                pc = self.capture()
                ok = self.fine_registration(pc)
                pc.free()
                if ok:
                    print("register: fine alignment done")
                    if not self.dry_run:
                        self.cameraconfig.save()
                    if self.capturer is not None:
                        self._reload_cameraconfig_to_capturer()
                if not self.args.guided:
                    if not ok:
                        print("register: fine alignment failed")
                    break
                answer = self.ask("Another fine alignment pass (yes/no)", "no")
                if answer != "yes":
                    break
        elif self.verbose:
            print("register: skipping fine registration (single camera or --nofine)")

        if not self.dry_run:
            self.cameraconfig.save()
            print(f"register: wrote {self.cameraconfig.filename}")
        if self.proposed_cellsize:
            print(f"register: proposed cellsize {self.proposed_cellsize:.4f}")
        if self.args.output:
            aligned = self.capture()
            cwipc_write(self.args.output, aligned)
            aligned.free()
        if self.capturer is not None:
            self.capturer.stop()
        return 0


def main() -> int:
    parser = ArgumentParser(description="Register (calibrate/align) multiple cameras")
    parser.add_argument("--coarse", action="store_true", help="Force coarse (marker) registration")
    parser.add_argument("--nocoarse", action="store_true", help="Skip coarse registration")
    parser.add_argument("--nofloor", action="store_true", help="Skip floor alignment")
    parser.add_argument("--nofine", action="store_true", help="Skip fine alignment")
    parser.add_argument("--noregister", action="store_true", help="Only create the cameraconfig")
    parser.add_argument("--guided", action="store_true", help="Guide me through the whole registration procedure")
    parser.add_argument("--interactive", action="store_true", help="Show the stream; w captures for registration")
    parser.add_argument("--guided_noviewer", action="store_true", help="Guided prompts without the viewer window (scripted runs)")
    parser.add_argument("--paused", action="store_true", help="Start paused (with --guided for recordings)")
    parser.add_argument("--tabletop", action="store_true", help="Use the color-target coarse method / single-camera tabletop")
    parser.add_argument("--no_aruco", action="store_true", help="Coarse alignment with interactive selection instead of aruco")
    parser.add_argument("--rgb", action="store_true", help="Show RGB aux images in the interactive viewer")
    parser.add_argument("--correspondence", type=float, help="Max correspondence distance")
    parser.add_argument("--algorithm_analyzer", help="Analyzer algorithm class name")
    parser.add_argument("--algorithm_multicamera", help="Multicamera alignment algorithm class name")
    parser.add_argument("--algorithm_aligner", help="Pairwise aligner algorithm class name")
    parser.add_argument("--conf_init", action="append", metavar="KEY=VALUE", help="Override cameraconfig entries")
    parser.add_argument("--nograb", metavar="PLYFILE", help="Register PLYFILE instead of capturing")
    parser.add_argument("--skip", type=int, default=0, metavar="N", help="Skip N captures before registration")
    parser.add_argument("--dry-run", dest="dry_run", action="store_true", help="Don't save cameraconfig")
    parser.add_argument("--plot", action="store_true", help="Plot analysis distributions per stage")
    parser.add_argument("--output", metavar="FILE", help="Write the final aligned capture to FILE")
    parser.add_argument("recording", nargs="?", help="A directory with recordings to register")
    args = parser.parse_args()
    beginOfRun(args)
    rv = Registrator(args).run()
    endOfRun(args)
    return rv


if __name__ == "__main__":
    sys.exit(main())
