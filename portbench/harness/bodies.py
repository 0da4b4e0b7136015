"""Voxelized dynamic human bodies, generated on the device from a seed.

A configuration file (``portbench/configs/<name>.json``) describes an MPEG
dynamic-human sequence by its published shape: the voxel depth and the
lattice pitch it implies for a standing adult, about the published points
a frame, colour a point, 30 frames a second.  This module builds such a
sequence:

* the surface of a union of ellipsoids (head, neck, torso, pelvis, arms,
  hands, legs, feet; the ``body`` group of the file), posed by a walking
  motion sampled at the sequence's frame rate;
* the surface sampled uniformly by area (rejection on the area element),
  each sample moved inward by up to ``shell_voxels`` lattice steps (the
  captured surfaces are a few voxels thick), points inside another part
  dropped, each sample rounded to the integer voxel lattice, and each
  occupied lattice point kept once, as the voxelized datasets store it;
* a colour from the part (skin, hair, shirt, trousers, shoes), a stripe
  pattern and per-point noise; a tile from the azimuth, as a four-camera
  capture tags its points.

The seed moves the lattice against the 4 mm cells (a sub-cell offset of
the origin), jitters the part colours, draws the surface samples, and
orders the frames; the poses, and so the amount of work a frame holds, are the same
for every seed.  Everything but the posing (a few dozen ellipsoids, on the
host) runs on ``device`` in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# part classes and their base colours (r, g, b)
CLASSES = {"skin": (214, 168, 140), "hair": (60, 42, 30), "shirt": (40, 90, 160),
           "trousers": (52, 52, 60), "shoes": (25, 25, 25)}
CLASS_IDS = {name: i for i, name in enumerate(CLASSES)}


def _rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _frame_along(d: np.ndarray) -> np.ndarray:
    """A rotation whose second column is the unit vector ``d``."""
    d = d / np.linalg.norm(d)
    helper = np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    e1 = np.cross(d, helper)
    e1 /= np.linalg.norm(e1)
    e3 = np.cross(e1, d)
    return np.stack([e1, d, e3], axis=1)


def pose(body: dict, t: float) -> list[tuple[np.ndarray, np.ndarray, np.ndarray, str]]:
    """The ellipsoids (centre, rotation, radii, part class) of the body at
    time ``t`` seconds: a walk in place with swinging arms, bending knees
    and a slow turn.  Lengths in metres, scaled by ``height_m`` / 1.8;
    radii also by ``girth``."""
    s = body["height_m"] / 1.8
    g = body["girth"] * s
    w = 2.0 * math.pi * body["gait_hz"]
    yaw = _rot_y(0.3 * math.sin(0.5 * w * t))
    bob = np.array([0.0, 0.01 * math.sin(2 * w * t), 0.0]) * s
    parts = []

    def add(centre, rot, radii, cls):
        parts.append((yaw @ (np.asarray(centre) * s) + bob, yaw @ rot, np.asarray(radii, np.float64), cls))

    def limb(p0, p1, r, cls, flat=None):
        """An ellipsoid spanning p0..p1 (body coordinates, unscaled)."""
        p0, p1 = np.asarray(p0), np.asarray(p1)
        half = np.linalg.norm(p1 - p0) / 2 * s
        r0, r2 = (r, r) if flat is None else flat
        add((p0 + p1) / 2, _frame_along(p1 - p0), (r0 * g, half + 0.5 * min(r0, r2) * g, r2 * g), cls)

    eye = np.eye(3)
    add((0, 1.68, 0.01), eye, np.array([0.08, 0.11, 0.095]) * g, "skin")
    add((0, 1.71, -0.01), eye, np.array([0.083, 0.09, 0.09]) * g, "hair")
    add((0, 1.53, 0), eye, np.array([0.055, 0.08, 0.055]) * g, "skin")
    add((0, 1.30, 0), eye, np.array([0.165, 0.20, 0.11]) * g, "shirt")
    add((0, 1.10, 0), eye, np.array([0.145, 0.15, 0.10]) * g, "shirt")
    add((0, 0.93, 0), eye, np.array([0.165, 0.12, 0.11]) * g, "trousers")
    for side, ph in ((1.0, 0.0), (-1.0, math.pi)):
        swing = 0.45 * math.sin(w * t + ph)
        sh = np.array([0.19 * side, 1.43, 0.0])
        r_up = _rot_x(-swing)
        el = sh + r_up @ np.array([0.03 * side, -0.29, 0.0])
        r_fo = r_up @ _rot_x(-(0.3 + 0.25 * math.sin(w * t + ph + 0.5)))
        wr = el + r_fo @ np.array([0.01 * side, -0.26, 0.0])
        tip = wr + r_fo @ np.array([0.0, -0.17, 0.01])
        limb(sh, el, 0.048, "shirt")
        limb(el, wr, 0.038, "skin")
        limb(wr, tip, 0.0, "skin", flat=(0.042, 0.02))
        leg = 0.35 * math.sin(w * t + ph + math.pi)
        hip = np.array([0.095 * side, 0.92, 0.0])
        r_th = _rot_x(-leg)
        kn = hip + r_th @ np.array([0.005 * side, -0.43, 0.0])
        r_sh = r_th @ _rot_x(0.2 + 0.2 * max(0.0, math.sin(w * t + ph)))
        an = kn + r_sh @ np.array([0.0, -0.40, 0.0])
        limb(hip, kn, 0.075, "trousers")
        limb(kn, an, 0.05, "trousers")
        toe = an + r_sh @ np.array([0.0, -0.03, 0.17])
        heel = an + r_sh @ np.array([0.0, -0.05, -0.04])
        limb(heel, toe, 0.0, "shoes", flat=(0.045, 0.04))
    return parts


def _area(radii: np.ndarray) -> float:
    """An ellipsoid's surface area (Thomsen's formula, within 1.1 %)."""
    p = 1.6075
    a, b, c = radii ** p
    return 4 * math.pi * ((a * b + a * c + b * c) / 3) ** (1 / p)


def _surface(parts, density: float, shell: float, gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Points sampled uniformly by area on the union's outer surface, each
    moved inward along its normal by up to ``shell`` metres, as a capture's
    voxelized surface is some voxels thick: (xyz f64 [n, 3], the part
    index of each [n])."""
    cen = torch.tensor(np.stack([p[0] for p in parts]), dtype=torch.float64, device=device)
    rot = torch.tensor(np.stack([p[1] for p in parts]), dtype=torch.float64, device=device)
    rad = torch.tensor(np.stack([p[2] for p in parts]), dtype=torch.float64, device=device)
    # the area element of u -> radii * u on the unit sphere, for the rejection
    elem = torch.stack([rad[:, 1] * rad[:, 2], rad[:, 0] * rad[:, 2], rad[:, 0] * rad[:, 1]], 1)
    accept = elem.norm(dim=1) / np.sqrt(3) / elem.amax(1)  # a lower estimate of the acceptance
    want = [_area(p[2]) * density for p in parts]
    draws = torch.tensor([int(n / float(a)) + 64 for n, a in zip(want, accept)], device=device)
    part = torch.repeat_interleave(torch.arange(len(parts), device=device), draws)
    u = torch.randn((part.shape[0], 3), generator=gen, dtype=torch.float64, device=device)
    u = u / u.norm(dim=1, keepdim=True)
    e = (elem[part] * u).norm(dim=1) / elem[part].amax(1)
    keep = torch.rand(part.shape[0], generator=gen, dtype=torch.float64, device=device) < e
    part, u = part[keep], u[keep]
    normal = torch.einsum("nij,nj->ni", rot[part], u / rad[part])
    normal = normal / normal.norm(dim=1, keepdim=True)
    depth = torch.rand(part.shape[0], generator=gen, dtype=torch.float64, device=device) * shell
    xyz = cen[part] + torch.einsum("nij,nj->ni", rot[part], rad[part] * u) - depth[:, None] * normal
    outside = torch.ones(part.shape[0], dtype=torch.bool, device=device)
    for j in range(len(parts)):
        q = ((xyz - cen[j]) @ rot[j]) / rad[j]
        outside &= ((q * q).sum(1) >= 1.0) | (part == j)
    return xyz[outside], part[outside]


def make_sequence(cfg: dict, seed: int, device, capacity: int | None = None):
    """The configuration's sequence for ``seed``: a list of ``frames``
    (xyz f32 [capacity, 3], rgba int32 [capacity], count int32 0-d) on
    ``device``, zero past the count, in the seed's frame order, and the
    poses' frame indices in that order."""
    body = cfg["body"]
    pitch = body["lattice_m"]
    depth = cfg["dataset"]["voxel_depth"]
    cell = cfg["chain"]["cellsize"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    # the lattice origin: the body centred in x and z, the feet on y = 0,
    # moved by a sub-cell offset drawn from the seed
    shift = torch.rand(3, generator=gen, dtype=torch.float64, device=device).cpu().numpy() * cell
    i0 = np.array([1 << (depth - 1), int(round(body["floor_voxel"])), 1 << (depth - 1)], np.int64)
    origin = -i0 * pitch + shift
    jitter = torch.randint(-24, 25, (len(CLASSES), 3), generator=gen, device=device)
    base = torch.tensor(list(CLASSES.values()), device=device) + jitter
    nframes = cfg["frames"]
    order = torch.randperm(nframes, generator=gen, device=device).cpu().tolist()
    frames = []
    for f in order:
        parts = pose(body, f / cfg["dataset"]["fps"])
        shell = body["shell_voxels"]
        xyz, part = _surface(parts, body["oversample"] * (1 + shell) / pitch**2, shell * pitch, gen, device)
        lat = torch.round(xyz / pitch).to(torch.int64) + torch.as_tensor(i0, device=device)
        if not bool(((lat >= 0) & (lat < 1 << depth)).all()):
            raise ValueError(f"{cfg['name']}: frame {f} leaves the {depth}-bit lattice")
        key = (lat[:, 0] << 42) | (lat[:, 1] << 21) | lat[:, 2]
        ukey, inv = torch.unique(key, return_inverse=True)
        first = torch.full((ukey.shape[0],), part.shape[0], dtype=torch.int64, device=device)
        first.scatter_reduce_(0, inv, torch.arange(part.shape[0], device=device), "amin")
        cls = torch.tensor([CLASS_IDS[p[3]] for p in parts], device=device)[part[first]]
        ilat = torch.stack([ukey >> 42, (ukey >> 21) & 0x1FFFFF, ukey & 0x1FFFFF], 1)
        pts = ilat.to(torch.float64) * pitch + torch.as_tensor(origin, device=device)
        n = pts.shape[0]
        rgb = base[cls]
        stripe = torch.sin(pts[:, 1] * (2 * math.pi / 0.08)) > 0
        rgb = rgb + torch.where((cls == CLASS_IDS["shirt"]) & stripe, 40, 0)[:, None]
        rgb = rgb + torch.randint(-6, 7, (n, 3), generator=gen, device=device)
        rgb = rgb.clamp(0, 255).to(torch.int32)
        azim = torch.atan2(pts[:, 0], pts[:, 2])
        cam = torch.floor((azim + math.pi + math.pi / 4) / (math.pi / 2)).to(torch.int64) % 4
        tile = (1 << cam).to(torch.int32)
        cap = n if capacity is None else capacity
        if n > cap:
            raise ValueError(f"{cfg['name']}: frame {f} holds {n} points, over the capacity {cap}")
        xyz32 = torch.zeros((cap, 3), dtype=torch.float32, device=device)
        xyz32[:n] = pts.to(torch.float32)
        rgba = torch.zeros(cap, dtype=torch.int32, device=device)
        rgba[:n] = (tile << 24) | (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
        frames.append((xyz32, rgba, torch.tensor(n, dtype=torch.int32, device=device)))
    return frames, order
