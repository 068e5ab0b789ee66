"""Synthetic photometric BA inputs, generated from numpy seeds.

``synth_pba_problem`` ports the JAX package's sphere-and-texture problem
(``photometric_bundle_adjustment_tpu/models/synthetic.py``) to tensors.

``euroc_scale_pba`` is the port's copy of ``build_euroc_scale_pba`` of the
JAX package's ``scripts/profile_pba.py``: EuRoC V1's image count and size
with uniform tracks (every landmark seen by the next 5 images), the
workload of the JAX package's dense photometric benchmark.

``wide_image_state`` is a pinhole toy state for the megakernel on an
image 8448 pixels wide, a linear ramp whose samples are exact.

``synth_pba_pipe`` builds a map-like object that ``refine_photometric`` of
both packages accepts: stereo image pairs rendered from inside a textured
sphere ("room"), ground-truth poses, a perturbed map (poses and inverse
depths), and a heavy tail of long tracks, as real maps have.  The object
holds plain Python and numpy only, so it deep-copies and crosses to the
JAX package unchanged; rendering uses the port's camera models on the CPU
in float64.

``synth_stereo_sequence`` renders the same room, trajectory and EuRoC
double-sphere stereo rig with a corner-rich texture (grey blocks in world
coordinates), for the SfM front end: at 480x752 each image yields about
EuRoC's 350 to 450 Shi-Tomasi corners.  Its ``correspondence`` maps a pixel
of one image to the pixel of the same room point in another image, from
the rendered geometry.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.core import cameras, se3
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba

# ---------------------------------------------------------------------------
# an image wider than the TPU kernel's column field
# ---------------------------------------------------------------------------


def wide_image_state(N: int = 300, seed: int = 0, *, device="cuda"):
    """A pinhole toy state whose projections land at x in [8000, 8440] of
    a 16 x 8448 linear ramp I = a x + b y + c (wider than the TPU kernel's
    14-bit column field): two cameras at the identity rotation, the second
    1 mm to the side (a parallax of about 8 px, so the inverse-depth column
    of the Jacobian is not zero), bearings aimed at the targets, unit
    inverse depths, zero affine and reference patch, and every fifth
    column a zero column, on ``device``.  Returns (images,
    cams, rho, consts, (a, b, c)): the megakernel's inputs
    (``ops.pba_mega.mega_fused``) and the ramp's coefficients."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega

    device = devices.resolve(device)
    H, W, P = 16, 8448, pba_mega.P
    a, b, c = 0.01, 0.5, 10.0
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64),
                            indexing="ij")
    images = (a * xs + b * ys + c).float()[None].repeat(2, 1, 1)
    rng = np.random.default_rng(seed)
    u = rng.uniform(8000, 8430, (P, N))
    v = rng.uniform(0.5, H - 1.5, (P, N))
    d = np.stack([u, v, np.ones_like(u)])                     # (3, P, N)
    d = d / np.linalg.norm(d, axis=0)
    idx = np.zeros((N,), np.int64)
    timg = np.where(np.arange(N) % 5 == 4, -1, np.arange(N) % 2)
    f32 = dict(dtype=torch.float32, device=device)
    intr = torch.zeros((8, N), **f32)
    intr[0:2] = 1.0                                           # fx = fy = 1
    pose = torch.zeros((2, 7), **f32)
    pose[:, 6] = 1.0
    pose[1, 0] = -1e-3
    cams = pba.PhotometricCams(pose=pose, affine=torch.zeros((2, 2), **f32))
    rho = torch.ones((1,), **f32)
    i64 = dict(dtype=torch.int64, device=device)
    an = torch.as_tensor(idx, **i64)
    tn = torch.as_tensor(np.arange(N) % 2, **i64)
    tg = torch.as_tensor(timg, **i64)
    consts = pba_mega.MegaConsts(
        d3=torch.as_tensor(d.reshape(3 * P, N), **f32), intr_t=intr,
        refp=torch.zeros((P, N), **f32), an=an, tn=tn, lm=an, timg=tg,
        cols=torch.stack([an, tn, an, tg]).to(torch.int32))
    return images.to(device), cams, rho, consts, (a, b, c)


# ---------------------------------------------------------------------------
# the JAX package's sphere problem
# ---------------------------------------------------------------------------


def synth_pba_problem(K: int = 4, L: int = 128, H: int = 64, W: int = 96,
                      seed: int = 0, pose_noise: float = 0.003,
                      depth_noise: float = 0.02, dtype=torch.float32, *,
                      device="cuda"):
    """Photometric BA problem on a rendered curved (sphere) scene with a
    smooth texture.  Returns (problem, images_flat, H, W, poses_gt,
    inv_depth_gt), with the JAX function's random draws and layout."""
    device = devices.resolve(device)
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


def euroc_scale_pba(K: int = 164, L: int = 4800, obs_per_lm: int = 5,
                    H: int = 480, W: int = 752, seed: int = 0,
                    dtype=torch.float32, *, device="cuda"):
    """A photometric problem at EuRoC scale with a uniform observation
    graph: K random images (uniform noise; content is irrelevant for
    throughput), pinhole intrinsics, a forward trajectory with small
    rotations, L landmarks anchored at random images and seen by the next
    ``obs_per_lm`` images.  Frames 0 and 1 are fixed.  The numpy draws are
    those of the JAX package's ``build_euroc_scale_pba``.  Returns
    (problem, images_flat, H, W) on ``device``."""
    device = devices.resolve(device)
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (K, H, W)).astype(np.float32)
    images_flat = torch.as_tensor(imgs.reshape(-1), device=device).to(dtype)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    intr = t([458.0, 457.0, W / 2, H / 2, 0, 0, 0, 0])
    xi = np.zeros((K, 6))
    xi[:, 0] = np.arange(K) * 0.05
    xi[:, 1:3] = rng.normal(0, 0.02, (K, 2))
    xi[:, 3:] = rng.normal(0, 0.01, (K, 3))
    poses = se3.exp(t(xi))

    anchor_of_lm = rng.integers(0, K - 8, L)
    uv_ref = np.stack([rng.uniform(8, W - 8, L), rng.uniform(8, H - 8, L)], -1)
    inv_depth = 1.0 / rng.uniform(2.0, 12.0, L)
    # sliding-window targets: each landmark seen in the next few frames
    j = np.arange(1, obs_per_lm + 1)[:, None]
    obs_a = np.tile(anchor_of_lm, obs_per_lm)
    obs_c = np.minimum(anchor_of_lm[None, :] + j, K - 1).reshape(-1)
    obs_l = np.tile(np.arange(L), obs_per_lm)
    O = obs_a.shape[0]

    ref_patch = pba.extract_ref_patches(
        images_flat, torch.as_tensor(anchor_of_lm, device=device), t(uv_ref),
        H, W)
    obs_l_t = torch.as_tensor(obs_l, device=device)
    problem = pba.build_problem(
        poses=poses,
        affine=torch.zeros((K, 2), dtype=dtype, device=device),
        inv_depth=t(inv_depth),
        anchor_cam=obs_a,
        target_cam=obs_c,
        landmark=obs_l,
        uv_ref=t(uv_ref)[obs_l_t],
        ref_patch=ref_patch[obs_l_t],
        target_img=obs_c,
        intr_ref=intr.repeat(O, 1),
        intr_target=intr.repeat(O, 1),
        valid=np.ones(O, bool),
        fixed_cams=np.arange(K) < 2,
    )
    return problem, images_flat, H, W


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
    T_i_c: np.ndarray           # (2, 7) camera-to-body poses (left = body)


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


def _stereo_rig(n_frames: int, W: int, model: str):
    """EuRoC's double-sphere stereo rig (intrinsics scaled to width W) on
    a slow lateral sweep with a little wobble through the room.  Returns
    (intrinsics (2, 8), poses (2 n_frames, 7) T_w_c in image order
    (frame i // 2, cam i % 2), T_i_c (2, 7), room centre (3,)); float64."""
    s = W / 752.0
    intr = np.stack([np.r_[c[:4] * s, c[4:]] for c in _DS_752])
    if model == "pinhole":
        intr[:, 4:] = 0.0
    elif model != "ds":
        raise ValueError(f"the synthetic rig supports 'ds' and 'pinhole', "
                         f"not {model!r}")
    f64 = torch.float64
    f = np.arange(n_frames)
    xi = np.zeros((n_frames, 6))
    xi[:, 0] = 0.04 * f
    xi[:, 1] = 0.05 * np.sin(0.3 * f)
    xi[:, 2] = 0.05 * np.cos(0.2 * f) - 0.05
    xi[:, 3] = 0.02 * np.sin(0.25 * f)
    xi[:, 4] = 0.03 * np.sin(0.15 * f)
    xi[:, 5] = 0.01 * np.cos(0.35 * f)
    left = se3.exp(torch.as_tensor(xi, dtype=f64))
    # the right camera sits one baseline to the right of the left (body)
    T_i_c = torch.stack([
        torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=f64),
        se3.exp(torch.tensor([_BASELINE, 0.0, 0.0, 0.007, 0.0006, 0.001],
                             dtype=f64)),
    ])
    right = se3.compose(left, T_i_c[1])
    poses = torch.stack([left, right], dim=1).reshape(2 * n_frames, 7)
    center = torch.tensor([0.02 * n_frames, 0.0, 2.0], dtype=f64)
    return intr, poses, T_i_c.numpy(), center


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
    intr, poses, T_i_c, center = _stereo_rig(K // 2, W, model)
    s = W / 752.0
    intr_t = torch.as_tensor(intr, dtype=f64)
    keys = [(i // 2, i % 2) for i in range(K)]

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
        calib=SynthCalib(intrinsics=intr, cam_types=[model, model],
                         T_i_c=T_i_c),
        poses_gt={key: gt[i] for i, key in enumerate(keys)},
        inv_depth_gt=inv_depth_gt,
    )


# ---------------------------------------------------------------------------
# a stereo sequence for the SfM front end
# ---------------------------------------------------------------------------


@dataclass
class SynthSequence:
    images: dict                # {(frame, cam): (H, W) uint8}
    calib: SynthCalib
    poses_gt: dict              # {(frame, cam): pose7 T_w_c}
    center: np.ndarray          # (3,) room centre

    def correspondence(self, src, dst, uv: np.ndarray):
        """Pixels (N, 2) of image ``src`` mapped to image ``dst`` through
        the rendered room: unproject, intersect the room sphere, project.
        Returns (uv_dst (N, 2), in_front (N,) bool)."""
        f64 = torch.float64
        model = self.calib.cam_types[0]
        intr = torch.as_tensor(self.calib.intrinsics, dtype=f64)
        T_s = torch.as_tensor(self.poses_gt[src], dtype=f64)
        T_d = torch.as_tensor(self.poses_gt[dst], dtype=f64)
        d = cameras.unproject_unit(model, intr[src[1]],
                                   torch.as_tensor(uv, dtype=f64))
        o = se3.translation(T_s)
        dw = se3.quat_rotate(se3.rotation(T_s), d)
        p_w = o + _room_depth(o, dw, torch.as_tensor(self.center))[:, None] * dw
        p_c = se3.act(se3.inverse(T_d), p_w)
        uv_d = cameras.project(model, intr[dst[1]], p_c)
        return uv_d.numpy(), (p_c[:, 2] > 0).numpy()


# rays per pixel along each axis of the front-end sequence's rendering
_SUPERSAMPLE = 2


def _block_texture(p: torch.Tensor, cell: float, table: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Piecewise-constant grey blocks of a 3-D grid of ``cell`` metres,
    each a grey level of ``table`` picked by a hash of its cell, plus a
    weak copy of the smooth ``_texture`` so that no block is flat."""
    c = torch.floor(p / cell).to(torch.int64)
    h = (c[:, 0] * 73856093) ^ (c[:, 1] * 19349663) ^ (c[:, 2] * 83492791)
    return table[h.remainder(table.shape[0])] + 0.2 * (_texture(p, scale) - 128.0)


def synth_stereo_sequence(n_frames: int = 82, H: int = 480, W: int = 752,
                          seed: int = 0, cell: float | None = None, *,
                          device="cuda") -> SynthSequence:
    """``n_frames`` stereo frames (2 n_frames images of H x W) of the
    ``synth_pba_pipe`` room, trajectory and EuRoC double-sphere rig,
    rendered with grey blocks of ``cell`` metres (by default 0.95 m at
    752 px width, scaled so that blocks span the same pixels at any
    width), anti-aliased over _SUPERSAMPLE^2 rays per pixel.  The block
    greys come from ``seed``.  Rendering runs in float64 on ``device``."""
    device = devices.resolve(device)
    f64 = torch.float64
    model = "ds"
    intr, poses, T_i_c, center = _stereo_rig(n_frames, W, model)
    s = W / 752.0
    cell = 0.95 / s if cell is None else cell
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.uniform(25.0, 230.0, 4099), dtype=f64,
                            device=device)
    intr_t = torch.as_tensor(intr, dtype=f64, device=device)
    poses_d, center_d = poses.to(device), center.to(device)

    # _SUPERSAMPLE^2 ray offsets around each pixel centre
    n = _SUPERSAMPLE
    off = (torch.arange(n, dtype=f64, device=device) + 0.5) / n - 0.5
    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device=device),
                            torch.arange(W, dtype=f64, device=device),
                            indexing="ij")
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    pix = torch.stack([xs[..., None] + ox.reshape(-1),
                       ys[..., None] + oy.reshape(-1)], -1).reshape(-1, 2)
    rays = [cameras.unproject_unit(model, intr_t[c], pix) for c in range(2)]
    keys = [(i // 2, i % 2) for i in range(2 * n_frames)]
    images = {}
    for i, key in enumerate(keys):
        o = se3.translation(poses_d[i])
        dw = se3.quat_rotate(se3.rotation(poses_d[i]), rays[key[1]])
        p_w = o + _room_depth(o, dw, center_d)[:, None] * dw
        img = _block_texture(p_w, cell, table, s).reshape(H, W, n * n)
        img = torch.clamp(torch.round(img.mean(-1)), 0, 255)
        images[key] = img.to(torch.uint8).cpu().numpy()
    gt = poses.numpy()
    return SynthSequence(
        images=images,
        calib=SynthCalib(intrinsics=intr, cam_types=[model, model],
                         T_i_c=T_i_c),
        poses_gt={key: gt[i] for i, key in enumerate(keys)},
        center=center.numpy(),
    )
