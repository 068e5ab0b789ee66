"""Kernel #1's byte count never charges more than a plain implementation
reads: the plain reference's own residual pass is run with its image
reads recorded, at every pyramid level of a small room map, and charged
every tap it reads, its rows' int64 indices, each landmark's anchor
pixel, reference patch and inverse depth once, and every camera."""

from __future__ import annotations

import pytest
import torch

from benchmark import roofline, scenes
from benchmark.reference import photometric as ref

torch.set_num_threads(1)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_mega_bytes_within_plain_reads(level, monkeypatch):
    room = scenes.RoomScene(dict(
        K=10, L=80, H=64, W=96, obs_per_lm=3, long_tracks=6, max_track=8,
        model="ds", trans_noise=0.02, rot_noise=0.002, depth_noise=0.03,
        keep=0.95), seed=5)
    prob = ref.MapProblem(room.request(1), "cpu", torch.float32)
    images = ref.pyramid(prob.images, 3)[level]
    rows = prob.level_rows(images, level)

    reads = []
    plain = ref.bilinear

    def recording(imgs, img, uv):
        if imgs is images and uv.shape[0] == prob.anchor.shape[0]:
            _, H, W = imgs.shape
            x = torch.clamp(uv[..., 0], 0.0, W - 1.001).floor().long()
            y = torch.clamp(uv[..., 1], 0.0, H - 1.001).floor().long()
            base = img * (H * W) + y * W + x
            reads.append(torch.stack([base, base + 1, base + W,
                                      base + W + 1], -1).reshape(-1))
        return plain(imgs, img, uv)

    monkeypatch.setattr(ref, "bilinear", recording)
    ref.lmr.SchurLM(prob.residual, ref.retract, 8, ref.HUBER,
                    prob.fixed).cost(prob.cams0, prob.rho0, rows)
    monkeypatch.setattr(ref, "bilinear", plain)
    (taps,) = reads

    counted = roofline.mega_bytes(prob, images, level, prob.cams0, prob.rho0)
    texels = roofline.touched_texels(prob, images, level, prob.cams0,
                                     prob.rho0)
    assert torch.equal(torch.unique(texels), torch.unique(taps))
    n_rows = prob.anchor.shape[0]
    n_lms = torch.unique(prob.landmark).numel()
    assert n_lms < n_rows             # landmarks shared by several rows
    plain_bytes = (4 * taps.numel()                       # every tap read
                   + n_rows * 3 * 8                       # int64 indices
                   + n_lms * (2 * 4 + 8 * 4 + 4)          # once a landmark
                   + 9 * 4 * prob.cams0.shape[0])
    assert 4 * torch.unique(taps).numel() < counted <= plain_bytes
