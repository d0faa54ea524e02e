"""Scene / situation visualization export in numpy (the port's own copy of
``situation3d_tpu/eval/visualization.py``, which re-implements the exportable
parts of ``situation3d/utils/visualization.py`` and ``pc_utils.py``'s
PLY / OBJ writers): situation arrows as triangle meshes, activation-colored
point clouds, standard PLY / OBJ files and a software top-down PNG render in
place of the reference's open3d OffscreenRenderer images.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def write_ply_points(path: str, points: np.ndarray,
                     colors: Optional[np.ndarray] = None) -> None:
    """ASCII PLY point cloud; colors uint8 [N,3] optional (pc_utils.write_ply)."""
    n = len(points)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {n}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fh.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
            if colors is not None:
                row += f" {int(colors[i,0])} {int(colors[i,1])} {int(colors[i,2])}"
            fh.write(row + "\n")


def write_obj_mesh(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Wavefront OBJ triangle mesh (1-indexed faces)."""
    with open(path, "w") as fh:
        for v in vertices:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")


def create_arrow(start: Sequence[float], direction: Sequence[float],
                 length: float = 0.5, shaft_radius: float = 0.02,
                 head_radius: float = 0.05, head_frac: float = 0.3,
                 segments: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """Arrow triangle mesh from ``start`` along ``direction``
    (visualization.create_arrow:37, trimesh-free).

    Returns (vertices [V,3], faces [F,3])."""
    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-12)
    # orthonormal frame
    up = np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9 else np.array([1.0, 0, 0])
    u = np.cross(d, up)
    u /= max(np.linalg.norm(u), 1e-12)
    v = np.cross(d, u)
    start = np.asarray(start, np.float64)
    shaft_len = length * (1 - head_frac)

    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    circ = np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v

    verts = []
    faces = []
    base = start + circ * shaft_radius                     # shaft base ring
    top = start + d * shaft_len + circ * shaft_radius      # shaft top ring
    head = start + d * shaft_len + circ * head_radius      # head base ring
    tip = start + d * length                               # arrow tip
    verts.extend(base)
    verts.extend(top)
    verts.extend(head)
    verts.append(tip)
    verts.append(start)                                    # shaft bottom center
    V = np.asarray(verts)
    tip_i = 3 * segments
    bot_i = 3 * segments + 1
    for i in range(segments):
        j = (i + 1) % segments
        faces.append((i, j, segments + i))                 # shaft side
        faces.append((j, segments + j, segments + i))
        faces.append((2 * segments + i, 2 * segments + j, tip_i))  # head cone
        faces.append((j, i, bot_i))                        # bottom cap
    return V.astype(np.float32), np.asarray(faces, np.int32)


def situation_arrows_obj(path: str, gt_pose: np.ndarray,
                         pred_pose: Optional[np.ndarray] = None,
                         length: float = 0.6) -> None:
    """Export GT (and optionally predicted) situation vectors as one OBJ.

    Poses are [x, y, z, qx, qy, qz, qw]; the arrow points along the
    quaternion-rotated +x axis (the reference's agent-facing convention)."""
    from scipy.spatial.transform import Rotation as R

    all_v, all_f = [], []
    offset = 0
    for pose in [gt_pose] + ([pred_pose] if pred_pose is not None else []):
        pose = np.asarray(pose, np.float64)
        facing = R.from_quat(pose[3:7]).apply([1.0, 0, 0])
        v, f = create_arrow(pose[:3], facing, length)
        all_v.append(v)
        all_f.append(f + offset)
        offset += len(v)
    write_obj_mesh(path, np.concatenate(all_v), np.concatenate(all_f))


def activation_colors(values: np.ndarray) -> np.ndarray:
    """Map scalar activations to a blue->red colormap, uint8 [N, 3]
    (visualization.py activation-colored clouds)."""
    v = np.asarray(values, np.float64)
    lo, hi = np.min(v), np.max(v)
    t = (v - lo) / max(hi - lo, 1e-12)
    r = np.clip(255 * t, 0, 255)
    b = np.clip(255 * (1 - t), 0, 255)
    g = np.clip(255 * (1 - np.abs(2 * t - 1)), 0, 255)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG writer (8-bit RGB, stdlib zlib only — no PIL/open3d)."""
    import struct
    import zlib

    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    hdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
                 + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def render_topdown(points: np.ndarray,
                   colors: Optional[np.ndarray] = None,
                   gt_pose: Optional[np.ndarray] = None,
                   pred_pose: Optional[np.ndarray] = None,
                   resolution: int = 512,
                   splat: int = 1,
                   arrow_length: float = 0.6) -> np.ndarray:
    """Software top-down point-splat render — the offline stand-in for the
    reference's open3d ``OffscreenRenderer`` image logging
    (``situation3d/eval/eval.py:247-314``, ``visualization.py:77-244``;
    open3d is unavailable here).

    Orthographic xy projection, painter's order by z (highest wins), each
    point splatted as a (2*splat+1)^2 square; GT situation arrow drawn
    green, predicted red (poses ``[x, y, z, qx, qy, qz, qw]``, facing =
    quaternion-rotated +x like ``situation_arrows_obj``).

    Returns uint8 [resolution, resolution, 3]."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    img = np.zeros((resolution, resolution, 3), np.uint8)
    if len(pts) == 0:
        return img
    lo = pts[:, :2].min(axis=0)
    hi = pts[:, :2].max(axis=0)
    span = max(float((hi - lo).max()), 1e-6)
    scale = (resolution - 1 - 2 * (splat + 1)) / span
    off = splat + 1

    def to_px(xy):
        px = np.clip((xy - lo) * scale + off, 0, resolution - 1)
        return px.astype(np.int64)

    if colors is None:
        colors = activation_colors(pts[:, 2])  # height colormap
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    order = np.argsort(pts[:, 2], kind="stable")  # later (higher) wins
    px = to_px(pts[order, :2])
    c = colors[order]
    for dy in range(-splat, splat + 1):
        for dx in range(-splat, splat + 1):
            yy = np.clip(px[:, 1] + dy, 0, resolution - 1)
            xx = np.clip(px[:, 0] + dx, 0, resolution - 1)
            img[resolution - 1 - yy, xx] = c

    def draw_arrow(pose, rgb):
        from scipy.spatial.transform import Rotation as R
        pose = np.asarray(pose, np.float64)
        facing = R.from_quat(pose[3:7]).apply([1.0, 0, 0])[:2]
        n = np.linalg.norm(facing)
        if n < 1e-9:
            return
        facing = facing / n
        tip = pose[:2] + facing * arrow_length
        left = tip - 0.25 * arrow_length * (
            facing + np.array([-facing[1], facing[0]]))
        right = tip - 0.25 * arrow_length * (
            facing - np.array([-facing[1], facing[0]]))
        for a, b in ((pose[:2], tip), (tip, left), (tip, right)):
            t = np.linspace(0.0, 1.0, 200)[:, None]
            seg = to_px(a[None] * (1 - t) + b[None] * t)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    yy = np.clip(seg[:, 1] + dy, 0, resolution - 1)
                    xx = np.clip(seg[:, 0] + dx, 0, resolution - 1)
                    img[resolution - 1 - yy, xx] = rgb

    if gt_pose is not None:
        draw_arrow(gt_pose, (0, 255, 0))
    if pred_pose is not None:
        draw_arrow(pred_pose, (255, 0, 0))
    return img


def export_scene_visualization(out_dir: str, tag: str, points: np.ndarray,
                               attention: Optional[np.ndarray] = None,
                               gt_pose: Optional[np.ndarray] = None,
                               pred_pose: Optional[np.ndarray] = None) -> None:
    """visualize_scene_test analogue: attention-colored cloud + arrows as
    PLY/OBJ geometry PLUS a rendered top-down PNG image artifact (the
    reference logs OffscreenRenderer images; eval.py:302-314)."""
    os.makedirs(out_dir, exist_ok=True)
    colors = activation_colors(attention) if attention is not None else None
    write_ply_points(os.path.join(out_dir, f"{tag}_points.ply"), points, colors)
    if gt_pose is not None:
        situation_arrows_obj(os.path.join(out_dir, f"{tag}_situation.obj"),
                             gt_pose, pred_pose)
    img = render_topdown(points, colors, gt_pose, pred_pose)
    write_png(os.path.join(out_dir, f"{tag}_render.png"), img)
