"""Synthetic 3D world renderer for end-to-end SLAM tests: textured square
sprites at random depths, drawn with a painter's sort — enough structure for
FAST corners + BRIEF matching with genuine parallax (non-planar scene, so the
essential matrix stays well-conditioned)."""
from __future__ import annotations

import numpy as np


def make_world(rng, n_sprites=260, x_range=(-6, 14), y_range=(-4, 4), z_range=(6, 18)):
    pts = np.stack([
        rng.uniform(*x_range, n_sprites),
        rng.uniform(*y_range, n_sprites),
        rng.uniform(*z_range, n_sprites),
    ], 1)
    sizes = rng.uniform(0.12, 0.35, n_sprites)  # world-space half width
    intensities = rng.uniform(30, 255, n_sprites)
    return {"pts": pts, "sizes": sizes, "intensities": intensities}


def render_with_depth(world, T_w2c, K, width=320, height=240, bg=110.0, bg_depth=0.0):
    """Like render() but also returns a per-pixel depth map (0 = no sprite)."""
    img = render(world, T_w2c, K, width, height, bg)
    zbuf = np.full((height, width), bg_depth, np.float32)
    R, t = T_w2c[:3, :3], T_w2c[:3, 3]
    pc = world["pts"] @ R.T + t
    order = np.argsort(-pc[:, 2])
    f = K[0, 0]
    for i in order:
        x, y, z = pc[i]
        if z < 0.5:
            continue
        u = f * x / z + K[0, 2]
        v = K[1, 1] * y / z + K[1, 2]
        s = f * world["sizes"][i] / z
        if s < 0.7:
            continue
        ix0, ix1 = max(int(np.floor(u - s)), 0), min(int(np.ceil(u + s)), width)
        iy0, iy1 = max(int(np.floor(v - s)), 0), min(int(np.ceil(v + s)), height)
        if ix1 <= ix0 or iy1 <= iy0:
            continue
        zbuf[iy0:iy1, ix0:ix1] = z
    return img, zbuf


def stereo_pair(world, T_w2c, K, baseline, width=320, height=240):
    """Rectified stereo: right camera displaced +baseline along the left
    camera's x axis."""
    left = render(world, T_w2c, K, width, height)
    T_right = T_w2c.copy()
    T_right[0, 3] -= baseline  # world point x maps to x - b in right cam
    right = render(world, T_right, K, width, height)
    return left, right


def render(world, T_w2c, K, width=320, height=240, bg=110.0):
    """Anti-aliased sprite rendering: square edges at true subpixel positions
    with per-pixel coverage blending — observations are then consistent 3D
    corners across views (no size-quantization bias)."""
    img = np.full((height, width), bg, np.float32)
    R, t = T_w2c[:3, :3], T_w2c[:3, 3]
    pc = world["pts"] @ R.T + t
    order = np.argsort(-pc[:, 2])  # far first (painter's algorithm)
    f = K[0, 0]
    for i in order:
        x, y, z = pc[i]
        if z < 0.5:
            continue
        u = f * x / z + K[0, 2]
        v = K[1, 1] * y / z + K[1, 2]
        s = f * world["sizes"][i] / z  # float half-width
        if s < 0.7:
            continue
        u0, u1 = u - s, u + s
        v0, v1 = v - s, v + s
        ix0, ix1 = max(int(np.floor(u0)), 0), min(int(np.ceil(u1)), width)
        iy0, iy1 = max(int(np.floor(v0)), 0), min(int(np.ceil(v1)), height)
        if ix1 <= ix0 or iy1 <= iy0:
            continue
        xs = np.arange(ix0, ix1)
        ys = np.arange(iy0, iy1)
        cov_x = np.clip(np.minimum(u1, xs + 1) - np.maximum(u0, xs), 0.0, 1.0)
        cov_y = np.clip(np.minimum(v1, ys + 1) - np.maximum(v0, ys), 0.0, 1.0)
        cov = cov_y[:, None] * cov_x[None, :]
        region = img[iy0:iy1, ix0:ix1]
        img[iy0:iy1, ix0:ix1] = region * (1 - cov) + world["intensities"][i] * cov
    return img


def camera_path(n_frames, step=0.25, yaw_rate=0.004):
    """Forward-lateral translation with slow yaw; returns (n, 4, 4) T_w2c."""
    Ts = []
    for i in range(n_frames):
        yaw = yaw_rate * i
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        C = np.array([step * i, 0.02 * i, 0.05 * i])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ C
        Ts.append(T)
    return np.stack(Ts)


def loop_path(n_frames, step=0.25, closes=1.05):
    """Closed circular trajectory: constant forward step with yaw rate
    2*pi*closes/n_frames, so after n_frames the camera has turned through
    ``closes`` full circles and revisits its start viewpoint. Returns
    (n, 4, 4) T_w2c. Circle radius ~= step / yaw_rate, center ~(-radius,0,0)."""
    yaw_rate = 2 * np.pi * closes / n_frames
    Ts = []
    C = np.zeros(3)
    yaw = 0.0
    for _ in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ C
        Ts.append(T)
        C = C + step * np.array([-s, 0, c])  # camera forward in world
        yaw += yaw_rate
    return np.stack(Ts)


def make_ring_world(rng, center, r_inner, r_outer, n_sprites=420, y_range=(-4, 4)):
    """Sprites on an annular wall around ``center`` — the world for a
    circular (loopy) trajectory: the camera always faces textured structure
    and the start view recurs at loop closure."""
    th = rng.uniform(0, 2 * np.pi, n_sprites)
    r = rng.uniform(r_inner, r_outer, n_sprites)
    pts = np.stack([
        center[0] + r * np.cos(th),
        rng.uniform(*y_range, n_sprites),
        center[2] + r * np.sin(th),
    ], 1)
    sizes = rng.uniform(0.12, 0.35, n_sprites)
    intensities = rng.uniform(30, 255, n_sprites)
    return {"pts": pts, "sizes": sizes, "intensities": intensities}


def render_sequence(rng, n_frames=12, width=320, height=240, f=260.0, step=0.25):
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    world = make_world(rng)
    Ts = camera_path(n_frames, step=step)
    frames = [render(world, T, K, width, height) for T in Ts]
    return frames, Ts, K, world


def make_textured_world(rng, n_surfaces=120, n_clutter=300, x_range=(-6, 14),
                        y_range=(-4, 4), z_range=(6, 18), cells=3):
    """Harder, KITTI-like statistics: textured macro-
    surfaces — each a cells x cells checker of random intensities, giving
    interior corners and gradient texture, not just isolated square outlines
    — plus small-sprite clutter at mixed depths for occlusion richness.
    Built by expanding each surface into adjacent sub-square sprites, so the
    anti-aliased renderer is reused unchanged (subpixel edges preserved)."""
    pts, sizes, intens = [], [], []
    for _ in range(n_surfaces):
        c = np.array([
            rng.uniform(*x_range), rng.uniform(*y_range), rng.uniform(*z_range)
        ])
        half = rng.uniform(0.35, 0.9)
        cell = 2.0 * half / cells
        base = rng.uniform(50, 200)
        for iy in range(cells):
            for ix in range(cells):
                off = np.array(
                    [(ix + 0.5) * cell - half, (iy + 0.5) * cell - half, 0.0]
                )
                pts.append(c + off)
                sizes.append(cell / 2.0)
                intens.append(float(np.clip(base + rng.uniform(-90, 90), 10, 255)))
    for _ in range(n_clutter):
        pts.append(np.array([
            rng.uniform(*x_range), rng.uniform(*y_range), rng.uniform(*z_range)
        ]))
        sizes.append(rng.uniform(0.08, 0.2))
        intens.append(rng.uniform(20, 255))
    return {
        "pts": np.stack(pts),
        "sizes": np.asarray(sizes),
        "intensities": np.asarray(intens),
    }


def render_sequence_hard(rng, n_frames=15, width=320, height=240, f=260.0,
                         step=0.2, noise=2.0, gain_drift=0.004,
                         bias_drift=0.25):
    """Textured world + photometric nuisance: per-frame exposure gain/bias
    drift and Gaussian sensor noise (the KITTI-ish conditions the plain
    sprite world lacks)."""
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    world = make_textured_world(rng)
    Ts = camera_path(n_frames, step=step)
    frames = []
    for i, T in enumerate(Ts):
        img = render(world, T, K, width, height)
        g = 1.0 + gain_drift * i
        b = bias_drift * i
        img = np.clip(
            img * g + b + rng.normal(0.0, noise, img.shape), 0.0, 255.0
        ).astype(np.float32)
        frames.append(img)
    return frames, Ts, K, world
