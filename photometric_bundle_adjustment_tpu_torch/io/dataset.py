"""EuRoC-style dataset loading (timestamps.txt + <timestamp>_<cam>.jpg),
mirroring load_data (src/sfm.cpp:889-931): frame ids are consecutive
integers in timestamp order, images are grayscale uint8 arrays.

A copy of ``photometric_bundle_adjustment_tpu/io/dataset.py``.  PIL is
imported only inside ``load_images``."""

from __future__ import annotations

import os

import numpy as np


def load_timestamps(dataset_path: str, max_frames: int = 0) -> list[int]:
    out = []
    with open(os.path.join(dataset_path, "timestamps.txt")) as f:
        for line in f:
            tok = line.strip()
            if not tok:
                continue
            try:
                out.append(int(tok))
            except ValueError:
                print(f"Skipping '{tok}' while reading times.")
                continue
            if max_frames > 0 and len(out) >= max_frames:
                break
    return out


def load_images(
    dataset_path: str, max_frames: int = 0, num_cams: int = 2
) -> tuple[dict, list[int]]:
    """Returns ({(frame_id, cam_id): (H, W) uint8 array}, timestamps)."""
    from PIL import Image

    timestamps = load_timestamps(dataset_path, max_frames)
    images = {}
    for fid, ts in enumerate(timestamps):
        for cam in range(num_cams):
            path = os.path.join(dataset_path, f"{ts}_{cam}.jpg")
            with Image.open(path) as im:
                images[(fid, cam)] = np.asarray(im.convert("L"), np.uint8)
    return images, timestamps
