"""The ``synth_ba`` scene kind: the synthetic multi-view reprojection
problem of ``scenes.synth_ba_arrays`` at its truth (fixed by
``map_seed``, else by the run's seed), perturbed per request."""

from benchmark.scenes import GeoScene, synth_ba_arrays


def make(params: dict, seed: int, device):
    p = dict(params)
    map_seed = p.pop("map_seed", seed)
    noise = {k: p.pop(k) for k in ("pose_noise", "depth_noise", "keep")}
    base, poses_gt, rho_gt = synth_ba_arrays(seed=int(map_seed), **p)
    base.poses, base.inv_depth = poses_gt, rho_gt
    return GeoScene(base, seed=seed, **noise)
