"""The ``room`` scene kind: the rendered stereo room (``scenes.RoomScene``)."""

from benchmark.scenes import RoomScene


def make(params: dict, seed: int, device):
    return RoomScene(params, seed, device=device)
