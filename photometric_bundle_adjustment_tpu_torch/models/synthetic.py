"""Synthetic photometric BA inputs, generated from numpy seeds.

``synth_pba_problem`` ports the JAX package's sphere-and-texture problem
(``photometric_bundle_adjustment_tpu/models/synthetic.py``) to tensors.

``synth_pba_pipe`` builds a map-like object that ``refine_photometric`` of
both packages accepts: stereo image pairs rendered from inside a textured
sphere ("room"), ground-truth poses, a perturbed map (poses and inverse
depths), and a heavy tail of long tracks, as real maps have.  The object
holds plain Python and numpy only, so it deep-copies and crosses to the
JAX package unchanged; rendering uses the port's camera models on the CPU
in float64.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch.core import cameras, se3
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba

# ---------------------------------------------------------------------------
# the JAX package's sphere problem
# ---------------------------------------------------------------------------


def synth_pba_problem(K: int = 4, L: int = 128, H: int = 64, W: int = 96,
                      seed: int = 0, pose_noise: float = 0.003,
                      depth_noise: float = 0.02, dtype=torch.float32, *,
                      device):
    """Photometric BA problem on a rendered curved (sphere) scene with a
    smooth texture.  Returns (problem, images_flat, H, W, poses_gt,
    inv_depth_gt), with the JAX function's random draws and layout."""
    rng = np.random.default_rng(seed)
    model = "pinhole"

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    intr = t([0.8 * W, 0.8 * W, W / 2, H / 2, 0, 0, 0, 0])
    sphere_c = t([0.5, 0.0, 14.0])
    sphere_r = 9.5

    def texture(p_xy):
        x, y = p_xy[..., 0], p_xy[..., 1]
        return (120.0 + 50.0 * torch.sin(1.7 * x) * torch.cos(2.3 * y)
                + 40.0 * torch.sin(3.1 * x + 2.0 * y))

    def ray_depth(o, dw):
        oc = o[None, :] - sphere_c[None, :]
        bq = torch.sum(dw * oc, dim=-1)
        cq = torch.sum(oc * oc, dim=-1) - sphere_r**2
        disc = torch.sqrt(torch.clamp(bq * bq - cq, min=1e-9))
        return -bq - disc

    xi = np.zeros((K, 6))
    xi[:, 0] = np.arange(K) * 0.35
    xi[:, 1] = rng.normal(0, 0.04, K)
    xi[:, 3:] = rng.normal(0, 0.008, (K, 3))
    xi[0] = 0
    poses_gt = se3.exp(t(xi))

    def render(T_w_c):
        ys, xs = torch.meshgrid(torch.arange(H, device=device),
                                torch.arange(W, device=device), indexing="ij")
        uv = torch.stack([xs.to(dtype), ys.to(dtype)], -1)
        d = cameras.unproject_unit(model, intr, uv.reshape(-1, 2))
        o = se3.translation(T_w_c)
        dw = se3.quat_rotate(se3.rotation(T_w_c), d)
        lam = ray_depth(o, dw)
        p_w = o[None, :] + lam[:, None] * dw
        return texture(p_w[:, :2]).reshape(H, W)

    images = torch.stack([render(poses_gt[k]) for k in range(K)])
    images_flat = images.reshape(-1)

    uv_ref = np.stack(
        [rng.uniform(8, W - 8, L), rng.uniform(8, H - 8, L)], -1
    )
    d = cameras.unproject_unit(model, intr, t(uv_ref))
    o0 = se3.translation(poses_gt[0])
    dw = se3.quat_rotate(se3.rotation(poses_gt[0]), d)
    inv_depth_gt = 1.0 / ray_depth(o0, dw)
    ref_patch = pba.extract_ref_patches(
        images_flat, torch.zeros(L, dtype=torch.int64, device=device),
        t(uv_ref), H, W,
    )

    obs_a = np.tile(np.zeros(L, np.int64), K - 1)
    obs_c = np.concatenate([np.full(L, k, np.int64) for k in range(1, K)])
    obs_l = np.tile(np.arange(L, dtype=np.int64), K - 1)
    O = L * (K - 1)

    dpose = np.zeros((K, 6))
    dpose[2:] = rng.normal(0, pose_noise, (K - 2, 6))
    poses0 = se3.right_plus(poses_gt, t(dpose))
    rho0 = inv_depth_gt * t(1.0 + rng.normal(0, depth_noise, L))

    problem = pba.build_problem(
        poses=poses0,
        affine=torch.zeros((K, 2), dtype=dtype, device=device),
        inv_depth=rho0,
        anchor_cam=obs_a,
        target_cam=obs_c,
        landmark=obs_l,
        uv_ref=t(uv_ref).repeat(K - 1, 1),
        ref_patch=ref_patch.repeat(K - 1, 1),
        target_img=obs_c,
        intr_ref=intr.repeat(O, 1),
        intr_target=intr.repeat(O, 1),
        valid=np.ones(O, bool),
        fixed_cams=np.arange(K) < 2,
    )
    return problem, images_flat, H, W, poses_gt, inv_depth_gt


# ---------------------------------------------------------------------------
# a map-like pipe for refine_photometric
# ---------------------------------------------------------------------------

# EuRoC's double-sphere calibration of cam0/cam1 at 752x480
# (tests/data/opt_calib_ds.json), scaled to the requested image size
_DS_752 = (
    np.array([351.04, 350.01, 365.89, 249.35, -0.2385, 0.5679, 0.0, 0.0]),
    np.array([362.95, 361.86, 378.32, 248.30, -0.2227, 0.5729, 0.0, 0.0]),
)
_BASELINE = 0.11                # EuRoC stereo baseline (m)
_ROOM_RADIUS = 10.0


@dataclass
class SynthLandmark:
    inv_depth: float
    obs: dict                   # {fcid: feature index in corners[fcid]}

    def anchor(self):
        """First observation in (frame, cam) order: the reference frame."""
        return min(self.obs)


@dataclass
class SynthCalib:
    intrinsics: np.ndarray      # (2, 8)
    cam_types: list


@dataclass
class SynthPipe:
    cameras: dict               # {(frame, cam): pose7 T_w_c}
    landmarks: dict             # {id: SynthLandmark}
    corners: dict               # {(frame, cam): {"uv": (n, 2)}}
    images: dict                # {(frame, cam): (H, W) uint8}
    calib: SynthCalib
    poses_gt: dict              # {(frame, cam): pose7}
    inv_depth_gt: dict          # {id: float}
    photometric_affine: dict = field(default_factory=dict)


def _texture(p: torch.Tensor, scale: float) -> torch.Tensor:
    """Smooth 3-D texture of world points (N, 3); ``scale`` stretches it so
    that it spans the same pixels at every image size."""
    x, y, z = (p * scale).unbind(-1)
    return (128.0 + 45.0 * torch.sin(1.3 * x + 0.4 * z) * torch.cos(1.1 * y)
            + 35.0 * torch.sin(2.9 * x + 2.1 * y - 0.7 * z)
            + 20.0 * torch.sin(6.1 * x - 4.3 * y + 3.3 * z))


def _room_depth(o: torch.Tensor, dw: torch.Tensor, center: torch.Tensor):
    """Distance along unit rays ``dw`` (N, 3) from ``o`` (inside the room
    sphere) to the sphere."""
    oc = o - center
    b = dw @ oc
    c = oc @ oc - _ROOM_RADIUS**2
    return -b + torch.sqrt(b * b - c)


def synth_pba_pipe(K: int = 12, L: int = 48, H: int = 64, W: int = 96,
                   obs_per_lm: int = 3, long_tracks: int = 0, seed: int = 0,
                   model: str = "ds", trans_noise: float = 0.02,
                   rot_noise: float = 2e-3, depth_noise: float = 0.03,
                   max_track: int = 96):
    """A perturbed stereo map with rendered images.

    K images (K/2 stereo frames, image i is (frame i // 2, cam i % 2)), L
    landmarks.  Each landmark is anchored at a random image and observed by
    the next ``obs_per_lm`` images; ``long_tracks`` of them instead by the
    next n images, n spread geometrically from ``max_track`` down (the
    heavy tail of real maps: EuRoC V1 has a landmark with 96 observations).
    Observations that project outside the image margin are dropped.  Frame
    0 keeps its ground-truth poses (the gauge); all other poses get
    right-plus noise of ``trans_noise`` (m) and ``rot_noise`` (rad), each
    about 0.7 px at the scene's ~10 m depth and EuRoC's focal length, and
    inverse depths relative noise of ``depth_noise``.
    """
    if K % 2 or K < 4:
        raise ValueError(f"K={K} must be even and >= 4 (stereo pairs)")
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    s = W / 752.0
    intr = np.stack([np.r_[c[:4] * s, c[4:]] for c in _DS_752])
    if model == "pinhole":
        intr[:, 4:] = 0.0
    elif model != "ds":
        raise ValueError(f"synth_pba_pipe supports 'ds' and 'pinhole', not {model!r}")
    intr_t = torch.as_tensor(intr, dtype=f64)
    n_frames = K // 2

    # trajectory: a slow lateral sweep with a little wobble; the right
    # camera sits one baseline to the right
    f = np.arange(n_frames)
    xi = np.zeros((n_frames, 6))
    xi[:, 0] = 0.04 * f
    xi[:, 1] = 0.05 * np.sin(0.3 * f)
    xi[:, 2] = 0.05 * np.cos(0.2 * f) - 0.05
    xi[:, 3] = 0.02 * np.sin(0.25 * f)
    xi[:, 4] = 0.03 * np.sin(0.15 * f)
    xi[:, 5] = 0.01 * np.cos(0.35 * f)
    left = se3.exp(torch.as_tensor(xi, dtype=f64))
    right = se3.compose(left, se3.exp(torch.tensor(
        [_BASELINE, 0.0, 0.0, 0.007, 0.0006, 0.001], dtype=f64)))
    poses = torch.stack([left, right], dim=1).reshape(K, 7)   # image order
    keys = [(i // 2, i % 2) for i in range(K)]
    center = torch.tensor([0.02 * n_frames, 0.0, 2.0], dtype=f64)

    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64),
                            torch.arange(W, dtype=f64), indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2)
    rays = [cameras.unproject_unit(model, intr_t[c], pix) for c in range(2)]
    images = {}
    for i, key in enumerate(keys):
        o = se3.translation(poses[i])
        dw = se3.quat_rotate(se3.rotation(poses[i]), rays[key[1]])
        p_w = o + _room_depth(o, dw, center)[:, None] * dw
        img = _texture(p_w, s).reshape(H, W)
        images[key] = np.clip(np.round(img.numpy()), 0, 255).astype(np.uint8)

    margin = 8.0 * max(s, 0.25)
    lengths = np.full(L, obs_per_lm, np.int64)
    if long_tracks:
        n_long = min(long_tracks, L)
        lengths[:n_long] = np.round(np.geomspace(
            min(max_track, K - 1), min(2 * obs_per_lm, K - 1), n_long))
    lengths = np.minimum(lengths, K - 1)
    anchors = rng.integers(0, K - lengths)                    # (L,)
    uv_a = np.stack([rng.uniform(margin, W - 1 - margin, L),
                     rng.uniform(margin, H - 1 - margin, L)], -1)
    corners_uv = {key: [] for key in keys}
    landmarks, inv_depth_gt = {}, {}
    for j in range(L):
        ia = int(anchors[j])
        cam_a = ia % 2
        d = cameras.unproject_unit(
            model, intr_t[cam_a], torch.as_tensor(uv_a[j], dtype=f64))
        o = se3.translation(poses[ia])
        dw = se3.quat_rotate(se3.rotation(poses[ia]), d)
        dist = _room_depth(o, dw[None], center)[0]
        p_w = o + dist * dw
        tgt = np.arange(ia + 1, ia + 1 + lengths[j])
        p_c = se3.act(se3.inverse(poses[tgt]), p_w[None])
        uv_t = cameras.project(model, intr_t[tgt % 2], p_c).numpy()
        inside = ((uv_t[:, 0] >= margin) & (uv_t[:, 0] <= W - 1 - margin)
                  & (uv_t[:, 1] >= margin) & (uv_t[:, 1] <= H - 1 - margin)
                  & (p_c[:, 2].numpy() > 0))
        if not inside.any():
            continue
        obs = {}
        for key, uv in [(keys[ia], uv_a[j])] + [
                (keys[i], uv_t[n]) for n, i in enumerate(tgt) if inside[n]]:
            obs[key] = len(corners_uv[key])
            corners_uv[key].append(uv)
        landmarks[j] = SynthLandmark(inv_depth=float(1.0 / dist), obs=obs)
        inv_depth_gt[j] = float(1.0 / dist)

    # perturb the map: every pose but frame 0's, every inverse depth
    noise = rng.normal(0, 1.0, (K, 6)) * np.repeat([trans_noise, rot_noise], 3)
    noise[:2] = 0.0
    poses0 = se3.right_plus(poses, torch.as_tensor(noise, dtype=f64)).numpy()
    for j, lm in landmarks.items():
        lm.inv_depth *= 1.0 + rng.normal(0, depth_noise)
    gt = poses.numpy()
    return SynthPipe(
        cameras={key: poses0[i] for i, key in enumerate(keys)},
        landmarks=landmarks,
        corners={key: {"uv": np.asarray(v, np.float64).reshape(-1, 2)}
                 for key, v in corners_uv.items()},
        images=images,
        calib=SynthCalib(intrinsics=intr, cam_types=[model, model]),
        poses_gt={key: gt[i] for i, key in enumerate(keys)},
        inv_depth_gt=inv_depth_gt,
    )
