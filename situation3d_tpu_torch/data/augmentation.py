"""Point-cloud color / geometry augmentations on the host, in numpy (the
port's own copy of ``situation3d_tpu/data/augmentation.py``): chromatic
translation / contrast / jitter, HSV shift, horizontal flip and elastic
distortion, the OpenScene set. Every draw comes from the given
``RandomState`` in the reference's order, so one seed gives the same
augmented scene in both packages. The SQA3D path uses only its rotation
(``data/sqa3d.py``); ``data/openscene_loader.py`` uses these.
"""
from __future__ import annotations

import numpy as np


def chromatic_translation(colors: np.ndarray, rng: np.random.RandomState,
                          trans_range_ratio: float = 0.1) -> np.ndarray:
    """Add a random global color offset (colors in 0..255)."""
    tr = (rng.rand(1, 3) - 0.5) * 255 * 2 * trans_range_ratio
    return np.clip(colors + tr, 0, 255)


def chromatic_auto_contrast(colors: np.ndarray, rng: np.random.RandomState,
                            randomize_blend_factor: bool = True,
                            blend_factor: float = 0.5) -> np.ndarray:
    lo = colors.min(0, keepdims=True)
    hi = colors.max(0, keepdims=True)
    scale = 255 / np.maximum(hi - lo, 1e-6)
    contrast = (colors - lo) * scale
    blend = rng.rand() if randomize_blend_factor else blend_factor
    return (1 - blend) * colors + blend * contrast


def chromatic_jitter(colors: np.ndarray, rng: np.random.RandomState,
                     std: float = 0.01) -> np.ndarray:
    noise = rng.randn(*colors.shape) * 255 * std
    return np.clip(colors + noise, 0, 255)


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb / 255.0
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    with np.errstate(invalid="ignore", divide="ignore"):
        rc = (maxc - r) / np.maximum(delta, 1e-12)
        gc = (maxc - g) / np.maximum(delta, 1e-12)
        bc = (maxc - b) / np.maximum(delta, 1e-12)
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta == 0, 0.0, (h / 6.0) % 1.0)
    return np.stack([h, s, v], -1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0).astype(int)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i % 6
    out = np.choose(i[..., None].repeat(3, -1),
                    [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
                     np.stack([p, v, t], -1), np.stack([p, q, v], -1),
                     np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return out * 255.0


def hue_saturation_translation(colors: np.ndarray, rng: np.random.RandomState,
                               hue_max: float = 0.5, sat_max: float = 0.2
                               ) -> np.ndarray:
    hsv = rgb_to_hsv(colors)
    hsv[..., 0] = (hsv[..., 0] + (rng.rand() - 0.5) * 2 * hue_max) % 1.0
    hsv[..., 1] = np.clip(hsv[..., 1] + (rng.rand() - 0.5) * 2 * sat_max, 0, 1)
    return np.clip(hsv_to_rgb(hsv), 0, 255)


def elastic_distortion(points: np.ndarray, rng: np.random.RandomState,
                       granularity: float, magnitude: float) -> np.ndarray:
    """Smooth random displacement field (augmentation.py elastic_distortion):
    trilinear-interpolated Gaussian-smoothed noise grid."""
    coords = points
    mins = coords.min(0)
    dims = np.maximum(((coords.max(0) - mins) // granularity).astype(int) + 3, 3)
    noise = rng.randn(*dims, 3).astype(np.float32)
    # separable box blur x3 ~ gaussian
    for _ in range(2):
        for axis in range(3):
            kernel = np.ones(3) / 3
            noise = np.apply_along_axis(
                lambda a: np.convolve(a, kernel, mode="same"), axis, noise)
    idx = (coords - mins) / granularity + 1
    i0 = np.floor(idx).astype(int)
    frac = idx - i0
    i0 = np.clip(i0, 0, np.asarray(dims) - 2)
    disp = np.zeros_like(coords)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (np.where(dx, frac[:, 0], 1 - frac[:, 0])
                     * np.where(dy, frac[:, 1], 1 - frac[:, 1])
                     * np.where(dz, frac[:, 2], 1 - frac[:, 2]))
                disp += w[:, None] * noise[i0[:, 0] + dx, i0[:, 1] + dy,
                                           i0[:, 2] + dz]
    return coords + disp * magnitude


def random_horizontal_flip(points: np.ndarray, rng: np.random.RandomState,
                           upright_axis: int = 2, p: float = 0.5
                           ) -> np.ndarray:
    pts = points.copy()
    for axis in range(3):
        if axis != upright_axis and rng.rand() < p:
            pts[:, axis] = pts[:, axis].max() - pts[:, axis]
    return pts
