"""Visualization: image overlays and 3D map rendering to PNG files.

Port of ``photometric_bundle_adjustment_tpu/utils/visualize.py``, the
headless replacement for the reference's Pangolin GUI layer
(draw_image_overlay sfm.cpp:484-802, draw_scene sfm.cpp:822-884,
render_camera gui_helper.h:40-69): detected corners, matches/inliers,
reprojections colour-coded by outlier status, and a 3D scatter of cameras +
landmarks, drawn from the port's ``SfmPipeline``.  Matplotlib, file output
only, on the host: outside the performance-critical path.  The epipolar
curves are projected by the port's camera models in float64 on the CPU.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_keypoints(image: np.ndarray, uv: np.ndarray, path: str,
                   color="red") -> None:
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(9, 6))
    ax.imshow(image, cmap="gray")
    ax.scatter(uv[:, 0], uv[:, 1], s=12, facecolors="none", edgecolors=color,
               linewidths=0.8)
    ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def draw_matches(
    img1: np.ndarray, img2: np.ndarray, uv1: np.ndarray, uv2: np.ndarray,
    pairs: np.ndarray, path: str, max_draw: int = 200,
) -> None:
    """Side-by-side match visualisation (show_matches overlay analog)."""
    plt = _mpl()
    H = max(img1.shape[0], img2.shape[0])
    W = img1.shape[1] + img2.shape[1]
    canvas = np.zeros((H, W), img1.dtype)
    canvas[: img1.shape[0], : img1.shape[1]] = img1
    canvas[: img2.shape[0], img1.shape[1]:] = img2
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.imshow(canvas, cmap="gray")
    off = img1.shape[1]
    for a, b in np.asarray(pairs)[:max_draw]:
        p, q = uv1[int(a)], uv2[int(b)]
        ax.plot([p[0], q[0] + off], [p[1], q[1]], lw=0.5)
    ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def draw_reprojections(pipe, fcid, path: str) -> None:
    """Measured corner -> reprojected landmark segments, red for flagged
    outliers, green for inliers (sfm.cpp:697-746 colouring)."""
    plt = _mpl()
    pipe.compute_projections()
    proj = pipe.image_projections.get(fcid, {"obs": [], "outlier_obs": []})
    img = pipe.images[fcid]
    fig, ax = plt.subplots(figsize=(9, 6))
    ax.imshow(img, cmap="gray")
    for rec in proj["obs"]:
        tid_uv = rec["uv_proj"]
        color = "red" if rec["flags"] else "lime"
        ax.plot([tid_uv[0]], [tid_uv[1]], "o", ms=3, mfc="none", color=color)
    ax.set_title(
        f"{fcid}: {len(proj['obs'])} obs, {len(proj['outlier_obs'])} outlier obs"
    )
    ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def draw_scene(pipe, path: str) -> None:
    """3D scatter of landmark positions + camera centres (draw_scene
    analog)."""
    plt = _mpl()
    tids = list(pipe.landmarks)
    pts = pipe.landmark_positions(tids) if tids else np.zeros((0, 3))
    cams = np.stack([np.asarray(p)[:3] for p in pipe.cameras.values()]) if (
        pipe.cameras
    ) else np.zeros((0, 3))
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c="k", alpha=0.5)
    if len(cams):
        ax.scatter(cams[:, 0], cams[:, 1], cams[:, 2], s=30, c="red",
                   marker="^")
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def draw_epipolar_curves(
    image: np.ndarray,
    T_this_other: np.ndarray,   # (7,) relative pose of the OTHER camera
    model: str,
    intrinsics: np.ndarray,     # (8,) this camera's intrinsics
    path: str,
    uv: np.ndarray | None = None,
    n_curves_half: int = 16,
    transform_p1: bool = True,
) -> None:
    """Epipolar-curve overlay (sfm.cpp:748-802 headless): for a camera
    pair with relative pose ``T_this_other``, draw the projections of the
    epipolar great circles through a fan of directions — under the
    distorted camera models these are CURVES, not lines, so each is a
    dense polyline  project(j * e  +  (1 - |j|) * p1),  j in [-1, 1]
    with e the normalised epipole direction (the reference's exact
    construction, including the +-pi/4 fan and 0.05 angular step).
    """
    import torch

    from photometric_bundle_adjustment_tpu_torch.core import cameras, se3

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64))

    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(image, cmap="gray")

    T = f64(T_this_other)
    e = se3.translation(T).numpy()
    e = e / max(np.linalg.norm(e), 1e-12)
    intr = f64(intrinsics)

    angles = np.arange(-np.pi / 4, np.pi / 4 + 1e-9, 0.05)
    js = np.linspace(-1.0, 1.0, 501)
    for i, ang in enumerate(angles):
        p1 = np.array([0.0, np.sin(ang), np.cos(ang)])
        if transform_p1:
            p1 = se3.act(T, f64(p1)).numpy()
        p1 = p1 / max(np.linalg.norm(p1), 1e-12)
        pts3 = js[:, None] * e[None, :] + (1.0 - np.abs(js))[:, None] * p1
        uv_line = cameras.project(model, intr, f64(pts3)).numpy()
        h, w = image.shape[:2]
        ok = (
            np.isfinite(uv_line).all(1)
            & (uv_line[:, 0] >= 0) & (uv_line[:, 0] < w)
            & (uv_line[:, 1] >= 0) & (uv_line[:, 1] < h)
        )
        # break the polyline where it leaves the image
        uv_plot = np.where(ok[:, None], uv_line, np.nan)
        ax.plot(uv_plot[:, 0], uv_plot[:, 1], color="cyan", lw=0.8,
                alpha=0.8)
        c = cameras.project(model, intr, f64(p1)).numpy()
        if np.isfinite(c).all() and 0 <= c[0] < w and 0 <= c[1] < h:
            ax.annotate(str(i), (c[0], c[1]), color="cyan", fontsize=6)

    if uv is not None and len(uv):
        ax.scatter(uv[:, 0], uv[:, 1], s=6, c="red", marker="x")
    ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)
