"""The benchmark's inputs: scenes made from ``--seed`` and one request per
``(seed, request index)``.

A traffic file (``benchmark/traffic/<name>.json``) names a scene kind and
its parameters; ``make_scene`` builds the scene once at set-up and
``scene.request(i)`` draws request ``i``'s input from ``(seed, i)``: a
fresh perturbation of the map and a fresh subset of its landmarks (each
kept with probability ``keep``), so no two requests share an observation
graph, as no two BA calls of an incremental SfM run do.  The same ``(seed,
i)`` always gives the same request, so the reference can rebuild any of
them after the window.

Three kinds, each made by ``benchmark/kinds/<kind>.py``:

* ``room``: the rendered stereo room of ``room_pipe`` (a copy of the
  program's ``synth_pba_pipe``: EuRoC's double-sphere stereo rig sweeping
  through a textured sphere, landmarks anchored at random images with a
  heavy tail of long tracks).  A request is a map object that
  ``refine_map`` accepts: it shares the rendered images and holds its own
  cameras and landmarks.
* ``synth_ba``: the multi-view reprojection problem of ``synth_ba_arrays``
  (a copy of the program's ``synth_ba_problem``), its pose and depth
  noise drawn anew for every request.
* ``map``: a geometric problem frozen into an ``.npz`` under
  ``benchmark/data/`` (``tools/freeze_v1map.py`` writes the real EuRoC V1
  map's), its free poses and inverse depths perturbed per request.

A traffic's ``map_seed`` fixes the scene (the room's landmarks, the
synthetic problem's geometry) whatever the run's seed, so that every seed
asks for the same work in other perturbations; without it the scene is
drawn from the run's seed too.

Geometric requests are ``GeoRequest``s of numpy arrays in float64; the
driver hands them to the program in the configuration's precision.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark import lie

DATA = Path(__file__).resolve().parent / "data"
KINDS = Path(__file__).resolve().parent / "kinds"


def request_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of request ``index`` of a run with ``seed`` (any
    non-negative integer, however large)."""
    return np.random.default_rng([int(seed), int(index), 0x5EED])


# ---------------------------------------------------------------------------
# the rendered stereo room (copy of the program's synth_pba_pipe)
# ---------------------------------------------------------------------------

# EuRoC's double-sphere calibration of cam0/cam1 at 752x480
_DS_752 = (
    np.array([351.04, 350.01, 365.89, 249.35, -0.2385, 0.5679, 0.0, 0.0]),
    np.array([362.95, 361.86, 378.32, 248.30, -0.2227, 0.5729, 0.0, 0.0]),
)
_BASELINE = 0.11                # EuRoC stereo baseline (m)
ROOM_RADIUS = 10.0


@dataclass
class Landmark:
    inv_depth: float
    obs: dict                   # {(frame, cam): feature index in corners}

    def anchor(self):
        """First observation in (frame, cam) order: the reference image."""
        return min(self.obs)


@dataclass
class Calib:
    intrinsics: np.ndarray      # (2, 8)
    cam_types: list
    T_i_c: np.ndarray           # (2, 7)


@dataclass
class Pipe:
    """What ``refine_map`` reads and writes of a map."""

    cameras: dict               # {(frame, cam): pose7 T_w_c}
    landmarks: dict             # {id: Landmark}
    corners: dict               # {(frame, cam): {"uv": (n, 2)}}
    images: dict                # {(frame, cam): (H, W) uint8}
    calib: Calib
    poses_gt: dict = field(default_factory=dict)
    inv_depth_gt: dict = field(default_factory=dict)
    photometric_affine: dict = field(default_factory=dict)


def _texture(p: torch.Tensor, scale: float) -> torch.Tensor:
    x, y, z = (p * scale).unbind(-1)
    return (128.0 + 45.0 * torch.sin(1.3 * x + 0.4 * z) * torch.cos(1.1 * y)
            + 35.0 * torch.sin(2.9 * x + 2.1 * y - 0.7 * z)
            + 20.0 * torch.sin(6.1 * x - 4.3 * y + 3.3 * z))


def _room_depth(o: torch.Tensor, dw: torch.Tensor, center: torch.Tensor,
                radius: float = ROOM_RADIUS):
    """Distance along unit rays ``dw`` (N, 3) from ``o`` to the sphere."""
    oc = o - center
    b = dw @ oc
    c = oc @ oc - radius ** 2
    return -b + torch.sqrt(b * b - c)


def _stereo_rig(n_frames: int, W: int, model: str):
    """(intrinsics (2, 8), poses (2 n_frames, 7) in image order, T_i_c
    (2, 7), room centre (3,)), float64."""
    s = W / 752.0
    intr = np.stack([np.r_[c[:4] * s, c[4:]] for c in _DS_752])
    if model == "pinhole":
        intr[:, 4:] = 0.0
    elif model != "ds":
        raise ValueError(f"the room's rig is 'ds' or 'pinhole', not "
                         f"{model!r}")
    f64 = torch.float64
    f = np.arange(n_frames)
    xi = np.zeros((n_frames, 6))
    xi[:, 0] = 0.04 * f
    xi[:, 1] = 0.05 * np.sin(0.3 * f)
    xi[:, 2] = 0.05 * np.cos(0.2 * f) - 0.05
    xi[:, 3] = 0.02 * np.sin(0.25 * f)
    xi[:, 4] = 0.03 * np.sin(0.15 * f)
    xi[:, 5] = 0.01 * np.cos(0.35 * f)
    left = lie.exp(torch.as_tensor(xi, dtype=f64))
    T_i_c = torch.stack([
        torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=f64),
        lie.exp(torch.tensor([_BASELINE, 0.0, 0.0, 0.007, 0.0006, 0.001],
                             dtype=f64)),
    ])
    right = lie.compose(left, T_i_c[1])
    poses = torch.stack([left, right], dim=1).reshape(2 * n_frames, 7)
    center = torch.tensor([0.02 * n_frames, 0.0, 2.0], dtype=f64)
    return intr, poses, T_i_c.numpy(), center


def render_room(poses: torch.Tensor, intr: np.ndarray, center, H: int,
                W: int, model: str, device="cpu") -> list:
    """The room seen by every camera of ``poses`` (image i is camera
    i % 2 of the rig), as (H, W) uint8 arrays; computed in float64 on
    ``device``."""
    f64 = torch.float64
    s = W / 752.0
    intr_t = torch.as_tensor(intr, dtype=f64, device=device)
    center = center.to(device)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device=device),
                            torch.arange(W, dtype=f64, device=device),
                            indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2)
    rays = [lie.unproject_unit(model, intr_t[c], pix) for c in range(2)]
    out = []
    for i in range(poses.shape[0]):
        pose = poses[i].to(device)
        o = lie.translation(pose)
        dw = lie.quat_rotate(lie.rotation(pose), rays[i % 2])
        p_w = o + _room_depth(o, dw, center)[:, None] * dw
        img = torch.clamp(torch.round(_texture(p_w, s)), 0, 255)
        out.append(img.reshape(H, W).to(torch.uint8).cpu().numpy())
    return out


def _sweep_reach(K: int) -> float:
    _, poses, _, center = _stereo_rig(K // 2, 752, "ds")
    return float(torch.linalg.norm(lie.translation(poses) - center,
                                   dim=-1).max())


def room_pipe(K: int = 12, L: int = 48, H: int = 64, W: int = 96,
              obs_per_lm: int = 3, long_tracks: int = 0, seed: int = 0,
              model: str = "ds", trans_noise: float = 0.02,
              rot_noise: float = 2e-3, depth_noise: float = 0.03,
              max_track: int = 96, render_device="cpu") -> Pipe:
    """A perturbed stereo map of the rendered room: K images (image i is
    (frame i // 2, cam i % 2)), L landmarks, each anchored at a random
    image and seen by the next ``obs_per_lm`` images, ``long_tracks`` of
    them by the next n, n spread geometrically from ``max_track`` down;
    observations outside the image margin dropped.  Frame 0 keeps its
    true poses; every other pose gets right-plus noise of ``trans_noise``
    (m) and ``rot_noise`` (rad), every inverse depth relative noise of
    ``depth_noise``.  The program's ``synth_pba_pipe`` with the same
    arguments gives the same map; ``render_device`` only moves the
    rendering."""
    if K % 2 or K < 4:
        raise ValueError(f"K={K} must be even and >= 4 (stereo pairs)")
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    if _sweep_reach(K) >= ROOM_RADIUS:
        raise ValueError(f"K={K}: the sweep leaves the room's sphere")
    intr, poses, T_i_c, center = _stereo_rig(K // 2, W, model)
    s = W / 752.0
    intr_t = torch.as_tensor(intr, dtype=f64)
    keys = [(i // 2, i % 2) for i in range(K)]
    images = dict(zip(keys, render_room(poses, intr, center, H, W, model,
                                        device=render_device)))

    margin = 8.0 * max(s, 0.25)
    lengths = np.full(L, obs_per_lm, np.int64)
    if long_tracks:
        n_long = min(long_tracks, L)
        lengths[:n_long] = np.round(np.geomspace(
            min(max_track, K - 1), min(2 * obs_per_lm, K - 1), n_long))
    lengths = np.minimum(lengths, K - 1)
    anchors = rng.integers(0, K - lengths)
    uv_a = np.stack([rng.uniform(margin, W - 1 - margin, L),
                     rng.uniform(margin, H - 1 - margin, L)], -1)
    corners_uv = {key: [] for key in keys}
    landmarks, inv_depth_gt = {}, {}
    for j in range(L):
        ia = int(anchors[j])
        d = lie.unproject_unit(model, intr_t[ia % 2],
                               torch.as_tensor(uv_a[j], dtype=f64))
        o = lie.translation(poses[ia])
        dw = lie.quat_rotate(lie.rotation(poses[ia]), d)
        dist = _room_depth(o, dw[None], center)[0]
        p_w = o + dist * dw
        tgt = np.arange(ia + 1, ia + 1 + lengths[j])
        p_c = lie.act(lie.inverse(poses[tgt]), p_w[None])
        uv_t = lie.project(model, intr_t[tgt % 2], p_c).numpy()
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
        landmarks[j] = Landmark(inv_depth=float(1.0 / dist), obs=obs)
        inv_depth_gt[j] = float(1.0 / dist)

    noise = rng.normal(0, 1.0, (K, 6)) * np.repeat([trans_noise, rot_noise], 3)
    noise[:2] = 0.0
    poses0 = lie.right_plus(poses, torch.as_tensor(noise, dtype=f64)).numpy()
    for lm in landmarks.values():
        lm.inv_depth *= 1.0 + rng.normal(0, depth_noise)
    gt = poses.numpy()
    return Pipe(
        cameras={key: poses0[i] for i, key in enumerate(keys)},
        landmarks=landmarks,
        corners={key: {"uv": np.asarray(v, np.float64).reshape(-1, 2)}
                 for key, v in corners_uv.items()},
        images=images,
        calib=Calib(intrinsics=intr, cam_types=[model, model], T_i_c=T_i_c),
        poses_gt={key: gt[i] for i, key in enumerate(keys)},
        inv_depth_gt=inv_depth_gt,
    )


class RoomScene:
    """``room_pipe``'s map as ground truth; each request perturbs it anew
    (the traffic's ``trans_noise``, ``rot_noise``, ``depth_noise``) and
    keeps each landmark with probability ``keep``."""

    def __init__(self, params: dict, seed: int, device="cpu"):
        p = dict(params)
        map_seed = p.pop("map_seed", seed)
        self.trans_noise = p.pop("trans_noise")
        self.rot_noise = p.pop("rot_noise")
        self.depth_noise = p.pop("depth_noise")
        self.keep = p.pop("keep")
        self.seed = seed
        base = room_pipe(seed=int(map_seed), render_device=device, **p)
        self.base = base
        self.keys = sorted(base.poses_gt)
        self.poses_gt = torch.as_tensor(
            np.stack([base.poses_gt[k] for k in self.keys]))
        self.lm_ids = sorted(base.landmarks)

    def request(self, i: int) -> Pipe:
        rng = request_rng(self.seed, i)
        K = len(self.keys)
        noise = rng.normal(0, 1.0, (K, 6)) * np.repeat(
            [self.trans_noise, self.rot_noise], 3)
        noise[:2] = 0.0
        poses = lie.right_plus(self.poses_gt,
                               torch.as_tensor(noise)).numpy()
        keep = rng.random(len(self.lm_ids)) < self.keep
        depth = 1.0 + rng.normal(0, self.depth_noise, len(self.lm_ids))
        b = self.base
        return Pipe(
            cameras={k: poses[n] for n, k in enumerate(self.keys)},
            landmarks={t: Landmark(b.inv_depth_gt[t] * depth[n],
                                   b.landmarks[t].obs)
                       for n, t in enumerate(self.lm_ids) if keep[n]},
            corners=b.corners, images=b.images, calib=b.calib)


# ---------------------------------------------------------------------------
# geometric problems
# ---------------------------------------------------------------------------


@dataclass
class GeoRequest:
    """A geometric BA problem as numpy arrays (float64): poses (K, 7),
    inverse depths (L,), one row per observation (anchor and target
    camera, landmark, measured and anchor pixel, the anchor's and the
    target's camera-type row of ``intrinsics``), fixed cameras (K,)."""

    model: str
    poses: np.ndarray
    inv_depth: np.ndarray
    anchor_cam: np.ndarray
    target_cam: np.ndarray
    landmark: np.ndarray
    uv_target: np.ndarray
    uv_ref: np.ndarray
    intr_ref: np.ndarray
    intr_target: np.ndarray
    fixed: np.ndarray


def synth_ba_arrays(model: str = "pinhole", K: int = 8, L: int = 256,
                    obs_per_landmark: int = 4, seed: int = 0,
                    pose_noise: float = 0.01, depth_noise: float = 0.03,
                    pixel_noise: float = 0.0, anchor_span: int | None = None,
                    point_spread: float | None = None):
    """A perturbed multi-view reprojection problem with EuRoC-like
    geometry (K cameras along x, L landmarks each anchored in one of the
    first ``anchor_span`` cameras, K/2 by default, and seen by the next
    ``obs_per_landmark``), computed in float64 on the CPU with the random
    draws of the program's ``synth_ba_problem`` (which is the default
    ``anchor_span``).  Returns (GeoRequest, poses_gt, inv_depth_gt).

    By default the landmarks lie anywhere along the whole trajectory,
    whatever camera anchors them; ``point_spread`` (m) puts each within
    that distance along x of the cameras that see it instead.

    With the default span, cameras past K/2 + ``obs_per_landmark`` see no
    landmark; ``anchor_span = K - obs_per_landmark`` has every camera seen
    and no track wrap round to camera 0."""
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    intr = torch.tensor(lie.PINHOLE_TEST, dtype=f64)
    if model != "pinhole":
        raise ValueError("the synthetic BA scene uses the pinhole model")

    xi = np.zeros((K, 6))
    xi[:, 0] = np.arange(K) * 0.25
    xi[:, 1] = rng.normal(0, 0.05, K)
    xi[:, 3:] = rng.normal(0, 0.02, (K, 3))
    xi[0] = 0
    poses_gt = lie.exp(torch.as_tensor(xi, dtype=f64))
    pts = np.stack([rng.uniform(-3, 3 + 0.25 * K, L), rng.uniform(-2, 2, L),
                    rng.uniform(4, 12, L)], axis=-1)
    pts_w = lie.act(poses_gt[0], torch.as_tensor(pts, dtype=f64))
    anchor_of_lm = rng.integers(0, anchor_span or max(K // 2, 1), L)
    if point_spread is not None:
        mid = 0.25 * (anchor_of_lm + (obs_per_landmark + 1) / 2)
        pts[:, 0] = mid + rng.uniform(-point_spread, point_spread, L)
        pts_w = lie.act(poses_gt[0], torch.as_tensor(pts, dtype=f64))
    p_a = lie.act(lie.inverse(poses_gt[anchor_of_lm]), pts_w)
    uv_ref = lie.project(model, intr, p_a)
    inv_depth_gt = 1.0 / torch.linalg.norm(p_a, dim=-1)

    obs_a, obs_c, uv_t_rows = [], [], []
    for j in range(obs_per_landmark):
        tgt = (anchor_of_lm + 1 + j) % K
        obs_a.append(anchor_of_lm)
        obs_c.append(tgt)
        p_t = lie.act(lie.inverse(poses_gt[tgt]), pts_w)
        uv = lie.project(model, intr, p_t).numpy()
        if pixel_noise > 0:
            uv = uv + rng.normal(0, pixel_noise, uv.shape)
        uv_t_rows.append(uv)
    O = L * obs_per_landmark

    dpose = np.zeros((K, 6))
    dpose[2:] = rng.normal(0, pose_noise, (K - 2, 6))
    poses0 = lie.right_plus(poses_gt, torch.as_tensor(dpose))
    rho0 = inv_depth_gt * torch.as_tensor(1.0 + rng.normal(0, depth_noise, L))
    intr_rows = np.tile(intr.numpy(), (O, 1))
    req = GeoRequest(
        model=model, poses=poses0.numpy(), inv_depth=rho0.numpy(),
        anchor_cam=np.concatenate(obs_a), target_cam=np.concatenate(obs_c),
        landmark=np.tile(np.arange(L), obs_per_landmark),
        uv_target=np.concatenate(uv_t_rows),
        uv_ref=np.tile(uv_ref.numpy(), (obs_per_landmark, 1)),
        intr_ref=intr_rows, intr_target=intr_rows.copy(),
        fixed=np.arange(K) < 2)
    return req, poses_gt.numpy(), inv_depth_gt.numpy()


class GeoScene:
    """A geometric problem whose state each request perturbs anew: every
    free pose by right-plus noise of ``pose_noise`` in each tangent
    component, every inverse depth by relative noise of ``depth_noise``;
    each landmark kept with probability ``keep`` (its rows go with it).
    ``base`` is the problem at the state the perturbations start from
    (``kinds/synth_ba.py``: ``synth_ba_arrays`` at the truth, its
    measured pixels keeping their noise; ``kinds/map.py``: a frozen
    problem at its saved state)."""

    def __init__(self, base: GeoRequest, pose_noise: float,
                 depth_noise: float, keep: float, seed: int):
        self.base = base
        self.pose_noise, self.depth_noise = pose_noise, depth_noise
        self.keep, self.seed = keep, seed

    def request(self, i: int) -> GeoRequest:
        rng = request_rng(self.seed, i)
        b = self.base
        K, L = b.poses.shape[0], b.inv_depth.shape[0]
        free = ~b.fixed
        d = np.zeros((K, 6))
        d[free] = rng.normal(0, self.pose_noise, (int(free.sum()), 6))
        poses = lie.right_plus(torch.as_tensor(b.poses),
                               torch.as_tensor(d)).numpy()
        poses[b.fixed] = b.poses[b.fixed]
        rho = b.inv_depth * (1.0 + rng.normal(0, self.depth_noise, L))
        keep = rng.random(L) < self.keep
        new_id = np.cumsum(keep) - 1
        rows = keep[b.landmark]
        return GeoRequest(
            model=b.model, poses=poses, inv_depth=rho[keep],
            anchor_cam=b.anchor_cam[rows], target_cam=b.target_cam[rows],
            landmark=new_id[b.landmark[rows]], uv_target=b.uv_target[rows],
            uv_ref=b.uv_ref[rows], intr_ref=b.intr_ref[rows],
            intr_target=b.intr_target[rows], fixed=b.fixed)


def load_map(path) -> GeoRequest:
    """A frozen geometric problem (``tools/freeze_v1map.py``'s layout:
    per-observation camera-type indices into ``intrinsics``)."""
    with np.load(path) as z:
        intr = z["intrinsics"]
        return GeoRequest(
            model=str(z["model"]), poses=z["poses"], inv_depth=z["inv_depth"],
            anchor_cam=z["anchor_cam"].astype(np.int64),
            target_cam=z["target_cam"].astype(np.int64),
            landmark=z["landmark"].astype(np.int64),
            uv_target=z["uv_target"], uv_ref=z["uv_ref"],
            intr_ref=intr[z["intr_ref"]], intr_target=intr[z["intr_target"]],
            fixed=z["fixed"])


def make_scene(traffic: dict, seed: int, device="cpu"):
    """The scene a traffic file describes: its ``scene`` key names the
    kind, whose maker is ``make(params, seed, device)`` in
    ``benchmark/kinds/<kind>.py`` (a new kind is a new file there);
    ``params`` are the kind's arguments."""
    kind = traffic["scene"]
    path = KINDS / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"unknown scene kind {kind!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_kind_" + kind.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(traffic["params"], seed, device)
