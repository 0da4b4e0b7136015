"""Capturer plugin registry and generic capturer factory.

The port of cwipc_util_tpu/models/capturer.py.  The registry is the
port's own; it lists the same types, and ``check_module`` gives the same
answers.  Re-implementation of the reference's capturer framework
(reference: src/cwipc_capturer.cpp:23-161, include/cwipc_util/internal/
capturers.hpp): external camera modules register a (name, countFunc,
factoryFunc) triple; the generic ``cwipc_capturer()`` factory dispatches on

* ``None``/"auto": probe every registered type's camera count and require
  exactly one type to be present,
* an inline JSON string (leading "{"): dispatch on its "type" field,
* a ``*.json`` filename: load it and dispatch on its "type" field.

Built-in capturer types:

* ``synthetic``  — the synthetic generator (with fps/npoints config keys),
* ``playback``   — recording replay: a cameraconfig with per-camera
  ``filename`` entries played through the playback sources (the reference's
  recording/replay path, _scriptsupport.py:176-190).

The device is explicit, as everywhere in the port: a factory takes the
config and the ``device`` its clouds go to (``None`` means CUDA).
Hardware plugins (realsense/kinect/orbbec equivalents) register through
``_cwipc_register_capturer``; none is installed, so they report themselves
absent, as they do in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.errors import CwipcError

CountFunc = Callable[[], int]
FactoryFunc = Callable[[Dict[str, Any], Any], Any]

_capturers: List[Tuple[str, CountFunc, FactoryFunc]] = []


def _cwipc_register_capturer(name: str, countFunc: CountFunc, factoryFunc: FactoryFunc) -> None:
    """Register a capturer type (plugin entry point)."""
    _capturers.append((name, countFunc, factoryFunc))


def cwipc_capturer_registry() -> List[str]:
    return [name for name, _, _ in _capturers]


def _synthetic_count() -> int:
    # The synthetic camera always "exists", but like the reference it never
    # wins auto-probing against real hardware; report 0 so "auto" requires
    # an explicit type or real cameras.
    return 0


def _synthetic_factory(config: Dict[str, Any], device=None):
    from .synthetic import cwipc_source_synthetic

    return cwipc_source_synthetic(
        fps=int(config.get("fps", 0)), npoints=int(config.get("npoints", 0)), device=device
    )


def _playback_count() -> int:
    return 0


def _playback_factory(config: Dict[str, Any], device=None):
    from .playback import cwipc_playback

    if "directory" in config:
        ext = config.get("ext", ".ply")
        directory = config["directory"]
        base = config.get("_config_dir", "")
        if base and not os.path.isabs(directory):
            # resolve against the config file's directory like the
            # per-camera filename entries below — a relative path must not
            # depend on the process cwd
            directory = os.path.join(base, directory)
        return cwipc_playback(
            directory,
            ext=ext,
            loop=bool(config.get("loop", False)),
            fps=config.get("fps"),
            device=device,
        )
    cameras = [c for c in config.get("camera", config.get("cameras", [])) if "filename" in c]
    if not cameras:
        raise CwipcError("playback capturer: no directory or camera filenames in config")
    if len(cameras) > 1:
        # Multi-camera recording: one file per camera, fused per frame with
        # per-camera trafos and cameraMask tiles (the reference's recording
        # replay path, internal/capturers.hpp:452-498).
        from .playback import cwipc_multicam_playback

        return cwipc_multicam_playback(config, device=device)
    base = config.get("_config_dir", "")
    fn = cameras[0]["filename"]
    if base and not os.path.isabs(fn):
        fn = os.path.join(base, fn)
    return cwipc_playback(
        [fn], ext=os.path.splitext(fn)[1] or ".ply",
        loop=bool(config.get("loop", False)), fps=config.get("fps"), device=device,
    )


_cwipc_register_capturer("synthetic", _synthetic_count, _synthetic_factory)
_cwipc_register_capturer("playback", _playback_count, _playback_factory)


def check_module(name: str) -> bool:
    """Probe whether an optional capturer/codec module is importable
    (reference: python/cwipc/util.py:1097-1115)."""
    if name in ("codec",):
        return True  # built in
    import importlib

    try:
        importlib.import_module(f"cwipc_util_tpu_torch.models.{name}")
        return True
    except ImportError:
        return False


def cwipc_capturer(conffile: Optional[str] = None, device=None):
    """Create a capturer from a config file / inline JSON / auto-probe,
    delivering clouds on ``device`` (``None`` means CUDA)."""
    if conffile is None or conffile == "auto":
        # evaluate each count() ONCE: hardware probes can be slow/racy
        counts = [(name, count()) for name, count, _ in _capturers]
        present = [(name, n) for name, n in counts if n > 0]
        if len(present) == 0:
            raise CwipcError(
                "cwipc_capturer: auto: no camera types detected; registered:"
                f" {cwipc_capturer_registry()}"
            )
        if len(present) > 1:
            raise CwipcError(
                f"cwipc_capturer: auto: multiple camera types present: {present}"
            )
        name = present[0][0]
        config: Dict[str, Any] = {"type": name}
    else:
        config = _load_capturer_config(conffile)
        name = config.get("type", "")
    return _dispatch_capturer(name, config, device)


def _load_capturer_config(conffile: str) -> Dict[str, Any]:
    if conffile.strip().startswith("{"):
        try:
            return json.loads(conffile)
        except json.JSONDecodeError as e:
            raise CwipcError(f"cwipc_capturer: invalid inline JSON: {e}") from e
    if conffile.endswith(".json"):
        if not os.path.exists(conffile):
            raise CwipcError(f"cwipc_capturer: no such config file: {conffile}")
        with open(conffile) as fp:
            try:
                config = json.load(fp)
            except json.JSONDecodeError as e:
                raise CwipcError(f"cwipc_capturer: invalid JSON in {conffile}: {e}") from e
        # per-camera relative filenames resolve against the config's dir
        config.setdefault("_config_dir", os.path.dirname(os.path.abspath(conffile)))
        return config
    raise CwipcError(
        f"cwipc_capturer: config must be 'auto', inline JSON or a .json file: {conffile}"
    )


def _dispatch_capturer(name: str, config: Dict[str, Any], device=None):
    for reg_name, _count, factory in _capturers:
        if reg_name == name:
            return factory(config, device)
    raise CwipcError(f'cwipc_capturer: unknown capturer type "{name}"')


def cwipc_capturer_of_type(name: str, conffile: Optional[str] = None, device=None):
    """Create a capturer of a SPECIFIC registered type — the typed
    plugin factories (cwipc_kinect()/cwipc_realsense2()/...) use this so
    they open THEIR camera kind regardless of what else is attached
    (the reference's per-plugin factory never auto-probes)."""
    if conffile is None or conffile == "auto":
        config: Dict[str, Any] = {"type": name}
    else:
        config = _load_capturer_config(conffile)
        config["type"] = name
    return _dispatch_capturer(name, config, device)
