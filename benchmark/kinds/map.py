"""The ``map`` scene kind: a geometric problem frozen under
``benchmark/data/`` (``scenes.load_map``), perturbed per request from its
saved state."""

from benchmark.scenes import DATA, GeoScene, load_map


def make(params: dict, seed: int, device):
    p = dict(params)
    base = load_map(DATA / p.pop("file"))
    noise = {k: p.pop(k) for k in ("pose_noise", "depth_noise", "keep")}
    if p:
        raise ValueError(f"map traffic: unknown keys {sorted(p)}")
    return GeoScene(base, seed=seed, **noise)
