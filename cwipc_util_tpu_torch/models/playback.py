"""File playback sources: .ply / .cwipcdump / .cwicpc directories or lists.

The port of cwipc_util_tpu/models/playback.py.  Every source takes the
``device`` its clouds go to (``None`` means CUDA): a file is read on the
host and uploaded once, when its cloud is first used.  The fused
multi-camera replay transforms, tags and joins the cameras' clouds on
that device and reads nothing back from it.

Re-implementation of the reference's playback module
(reference: python/cwipc/playback.py): loop mode with a single-file clone
cache, fps pacing, retimestamping, timestamp-from-filename digits,
tileconfig.json tile info, inpoint/outpoint filename filtering.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..abstract import cwipc_activesource_abstract
from ..core.buffers import resolve_device
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper


def _filename_timestamp(fn: str) -> int:
    digits = "".join(c for c in os.path.basename(fn) if c.isdigit())
    return int(digits) if digits else 0


class _Filesource(cwipc_activesource_abstract):
    """Plays back a list of .ply files as an active source."""

    def __init__(
        self,
        filenames: Union[str, List[str]],
        tileInfo: Optional[List[Dict[Any, Any]]] = None,
        loop: bool = False,
        fps: Optional[int] = None,
        retimestamp: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        if not tileInfo:
            tileInfo = [
                {"cameraName": "None", "cameraMask": 0, "normal": {"x": 0, "y": 0, "z": 0}}
            ]
        self.tileInfo = tileInfo
        self.filenames = list(filenames)
        self.loop = loop
        self.single_file_mode = self.loop and len(self.filenames) == 1
        self.single_file_mode_pc: Optional[cwipc_pointcloud_wrapper] = None
        self.retimestamp = retimestamp
        self.delta_t = 1.0 / fps if fps else 0.0
        self.earliest_return = time.time()

    # -- source protocol ---------------------------------------------------

    def free(self, *, force: bool = False) -> None:
        self.stop()

    def start(self) -> bool:
        return True

    def stop(self) -> None:
        self.filenames = []
        self.single_file_mode_pc = None

    def _advance_deadline(self) -> None:
        # absolute deadline ladder (like the synthetic source / the
        # reference's C++ sleep_until): scheduling relative to the wake
        # time accumulates sleep overshoot into every frame period and
        # under-delivers the nominal fps; resynchronize when more than a
        # period behind instead of bursting
        now = time.time()
        nxt = self.earliest_return + self.delta_t
        if nxt < now:
            nxt = now + self.delta_t
        self.earliest_return = nxt

    def seek(self, timestamp: int) -> bool:
        return False

    def eof(self) -> bool:
        if self.single_file_mode_pc is not None:
            return False
        return not self.filenames

    def available(self, wait: bool = False) -> bool:
        if self.single_file_mode_pc:
            return True
        return bool(self.filenames)

    def get(self) -> Optional[cwipc_pointcloud_wrapper]:
        if not self.filenames:
            if self.single_file_mode_pc:
                rv = self.single_file_mode_pc.clone()
                now = time.time()
                if now < self.earliest_return:
                    time.sleep(self.earliest_return - now)
                self._advance_deadline()
                if self.retimestamp:
                    rv._set_timestamp(int(time.time() * 1000))
                return rv
            return None
        fn = self.filenames.pop(0)
        # single-file loop mode serves the cached clone from the second
        # frame on — re-appending the name here would re-read the file from
        # disk every frame and never reach the cache branch above
        if self.loop and not self.single_file_mode:
            self.filenames.append(fn)
        rv = self._read_file(fn)
        if self.single_file_mode and rv:
            self.single_file_mode_pc = rv.clone()
        now = time.time()
        if now < self.earliest_return:
            time.sleep(self.earliest_return - now)
        self._advance_deadline()
        if self.retimestamp and rv is not None:
            rv._set_timestamp(int(time.time() * 1000))
        return rv

    def _read_file(self, fn: str) -> Optional[cwipc_pointcloud_wrapper]:
        from .. import cwipc_read

        return cwipc_read(fn, _filename_timestamp(fn), self.device)

    # -- tiling / config / metadata -----------------------------------------

    def maxtile(self) -> int:
        return len(self.tileInfo)

    def get_tileinfo_dict(self, i: int) -> Dict[Any, Any]:
        return self.tileInfo[i]

    def reload_config(self, config) -> None:
        return None

    def get_config(self) -> Optional[bytes]:
        return None

    def request_metadata(self, name: str) -> None:
        raise CwipcError("Not supported for playback sources")

    def is_metadata_requested(self, name: str) -> bool:
        return False

    def auxiliary_operation(self, op: str, inbuf: bytes, outbuf: bytearray) -> bool:
        return False

    def statistics(self) -> None:
        pass


class _DumpFilesource(_Filesource):
    """Plays back .cwipcdump files."""

    def _read_file(self, fn: str) -> Optional[cwipc_pointcloud_wrapper]:
        from .. import cwipc_read_debugdump

        return cwipc_read_debugdump(fn, self.device)


class _CompressedFilesource(_Filesource):
    """Plays back .cwicpc compressed files through the codec decoder."""

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        from ..codec import cwipc_new_decoder

        self.decoder = cwipc_new_decoder(self.device)

    def _read_file(self, fn: str) -> Optional[cwipc_pointcloud_wrapper]:
        with open(fn, "rb") as fp:
            data = fp.read()
        self.decoder.feed(data)
        return self.decoder.get()


def cwipc_playback(
    dir_or_files: Union[str, List[str]],
    ext: str = ".ply",
    loop: bool = False,
    fps: Optional[int] = None,
    inpoint: Optional[int] = None,
    outpoint: Optional[int] = None,
    retimestamp: bool = False,
    device=None,
) -> cwipc_activesource_abstract:
    """Source that plays .ply/.cwipcdump/.cwicpc files from a directory or
    list, delivering clouds on ``device`` (``None`` means CUDA)."""
    tileInfo = None
    ext = ext.lower()  # recordings with uppercase extensions are still valid
    if isinstance(dir_or_files, str):
        names = sorted(
            fn for fn in os.listdir(dir_or_files) if fn.lower().endswith(ext)
        )
        if not names:
            raise CwipcError(f"No {ext} files in {dir_or_files}")
        tileinfo_fn = os.path.join(dir_or_files, "tileconfig.json")
        if os.path.exists(tileinfo_fn):
            with open(tileinfo_fn) as fp:
                tileInfo = json.load(fp).get("tileInfo")
        dir_or_files = [os.path.join(dir_or_files, fn) for fn in names]
    # in/outpoint trim applies to explicit file lists too (the script layer
    # passes them regardless of the input form)
    if inpoint:
        dir_or_files = [
            fn for fn in dir_or_files if _filename_timestamp(fn) >= inpoint
        ]
    if outpoint:
        dir_or_files = [
            fn for fn in dir_or_files if _filename_timestamp(fn) <= outpoint
        ]
    if ext == ".ply":
        return _Filesource(dir_or_files, tileInfo=tileInfo, loop=loop, fps=fps, retimestamp=retimestamp,
                          device=device)
    if ext == ".cwipcdump":
        return _DumpFilesource(dir_or_files, tileInfo=tileInfo, loop=loop, fps=fps, retimestamp=retimestamp,
                              device=device)
    if ext == ".cwicpc":
        return _CompressedFilesource(dir_or_files, tileInfo=tileInfo, loop=loop, fps=fps, retimestamp=retimestamp,
                                    device=device)
    raise CwipcError(f"Unknown playback filetype {ext}")


class _MulticamPlayback(cwipc_activesource_abstract):
    """N per-camera recordings fused into one tiled stream.

    The reference replays per-camera recordings through the camera capturer
    stack, which applies each camera's cameraconfig trafo and tags points
    with cameraMask = 1 << camIndex before fusing
    (reference: internal/capturers.hpp:452-498, _scriptsupport.py:176-190).
    Each get() pulls one frame per camera, transforms it by the camera's
    4x4, overwrites the tile byte with the camera mask, and joins.

    In the port each camera's file is uploaded once a frame and the rest
    runs on the device: the transform in float64 (as the JAX package's
    host ``cwipc_transform`` computes it) rounded to float32, the tile byte
    through ``colormap`` and the join, with every count known on the host
    from the file, so nothing is read back.  The trafos go to the device
    once, here.
    """

    def __init__(self, sources, trafos, config_json: bytes, device=None):
        import torch

        self.sources = list(sources)
        if len(self.sources) > 8:
            # cameraMask is 1 << camIndex in an 8-bit tile byte
            raise CwipcError(
                f"at most 8 cameras supported (8-bit tile mask), got {len(self.sources)}"
            )
        self.trafos = [None if t is None else t for t in trafos]
        dev = resolve_device(device)
        # identity trafos are skipped, as the JAX package skips them
        self._trafos_dev = [
            None if t is None or np.allclose(t, np.identity(4))
            else torch.as_tensor(np.asarray(t, np.float64), device=dev)
            for t in self.trafos
        ]
        self._config_json = config_json

    def start(self) -> bool:
        # evaluate ALL (no short-circuit): a mid-list failure must not leave
        # half the cameras running/seeked while the rest never got the call
        return all([s.start() for s in self.sources])

    def stop(self) -> None:
        for s in self.sources:
            s.stop()

    def eof(self) -> bool:
        return any(s.eof() for s in self.sources)

    def available(self, wait: bool = False) -> bool:
        return all(s.available(wait) for s in self.sources)

    def get(self) -> Optional[cwipc_pointcloud_wrapper]:
        from .. import cwipc_join_multi
        from ..ops import compaction

        parts = []
        for i, src in enumerate(self.sources):
            pc = src.get()
            if pc is None:
                for p in parts:
                    p.free()
                return None
            n = pc.count()  # known on the host: the file's points
            buf = pc._access_buffer()
            if self._trafos_dev[i] is not None:
                buf = _transform_f64(buf, self._trafos_dev[i])
            tagged = compaction.colormap(buf, 0xFF000000, (1 << i) << 24)
            parts.append(
                cwipc_pointcloud_wrapper(tagged, pc.timestamp(), pc.cellsize(), _count_hint=n)
            )
            pc.free()
        fused = cwipc_join_multi(parts)
        for p in parts:
            p.free()
        return fused

    def maxtile(self) -> int:
        return len(self.sources) + 1

    def get_tileinfo_dict(self, i: int) -> Dict[Any, Any]:
        ncam = len(self.sources)
        if i == 0:
            return dict(normal=dict(x=0, y=0, z=0), cameraName="",
                        ncamera=ncam, cameraMask=(1 << ncam) - 1)
        return dict(normal=dict(x=0, y=0, z=0), cameraName=f"recording-{i - 1}",
                    ncamera=1, cameraMask=1 << (i - 1))

    def get_config(self) -> bytes:
        return self._config_json

    def reload_config(self, config) -> bool:
        return False

    def free(self, *, force: bool = False) -> None:
        self.stop()

    def request_metadata(self, name: str) -> None:
        self._metadata_wanted = getattr(self, "_metadata_wanted", set())
        self._metadata_wanted.add(name)

    def is_metadata_requested(self, name: str) -> bool:
        return name in getattr(self, "_metadata_wanted", set())

    def auxiliary_operation(self, op, inbuf=None, outbuf=None) -> bool:
        return False

    def seek(self, timestamp: int) -> bool:
        return all([s.seek(timestamp) for s in self.sources])

    def statistics(self) -> None:
        pass


def _transform_f64(buf, t):
    """xyz @ R^T + t in float64 on the buffer's device (``t``: a float64
    4x4 tensor there), rounded to float32: the JAX package's host
    ``cwipc_transform`` on the same float32 trafo."""
    import torch

    from ..core.buffers import PointBuffer

    xyz = (buf.xyz.double() @ t[:3, :3].T + t[:3, 3]).float()
    return PointBuffer(xyz=torch.where(buf.valid_mask()[:, None], xyz, 0.0), rgba=buf.rgba, count=buf.count)


def cwipc_multicam_playback(config: Dict[str, Any], device=None) -> _MulticamPlayback:
    """Build the fused multi-camera playback source from a playback-type
    cameraconfig (per-camera ``filename`` + ``trafo`` entries), delivering
    clouds on ``device`` (``None`` means CUDA)."""
    import json as _json

    base = config.get("_config_dir", "")
    cameras = config.get("camera", config.get("cameras", []))
    sources, trafos = [], []
    for cam in cameras:
        fn = cam["filename"]
        if base and not os.path.isabs(fn):
            fn = os.path.join(base, fn)
        ext = os.path.splitext(fn)[1]
        sources.append(
            # loop defaults OFF, matching the reference's --loop flag and
            # the single-camera playback path: a finite recording reaches
            # EOF so conversion jobs (cwipc copy/grab) terminate.  Live
            # replay opts in via "loop": true in the config or --loop.
            cwipc_playback([fn], ext=ext, loop=bool(config.get("loop", False)),
                           fps=config.get("fps"), device=device)
        )
        trafo = cam.get("trafo")
        trafos.append(None if trafo is None else np.asarray(trafo, np.float32))
    public = {k: v for k, v in config.items() if not k.startswith("_")}
    return _MulticamPlayback(sources, trafos, _json.dumps(public).encode("utf8"), device)
