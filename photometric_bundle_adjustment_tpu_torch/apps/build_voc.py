"""Build a BoW vocabulary from a dataset's images.

The reference only loads a prebuilt vocabulary (sfm.cpp:337-340); this
utility closes the loop so that the ``--voc-path`` matching mode is usable
without external files:

    python -m photometric_bundle_adjustment_tpu_torch.apps.build_voc \\
        --dataset-path data/euroc_V1 --output voc.pkl --max-frames 20 \\
        [--device cuda|cpu]

Port of ``photometric_bundle_adjustment_tpu/apps/build_voc.py``: corners
and descriptors of every image on ``--device`` (the card by default;
``features/describe.detect_and_describe``), then the hierarchical binary
k-means of ``features/bow.build_vocabulary`` on the host.  The vocabulary
file is the JAX package's pickle.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build BoW vocabulary")
    parser.add_argument("--dataset-path", required=True)
    parser.add_argument("--output", default="voc.pkl")
    parser.add_argument("--max-frames", type=int, default=20)
    parser.add_argument("--branching", type=int, default=10)
    parser.add_argument("--levels", type=int, default=3)
    parser.add_argument("--num-features", type=int, default=1500)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from photometric_bundle_adjustment_tpu_torch import device as devices
    from photometric_bundle_adjustment_tpu_torch import interop
    from photometric_bundle_adjustment_tpu_torch.features import bow, describe
    from photometric_bundle_adjustment_tpu_torch.io import dataset

    device = devices.resolve(args.device)
    images, timestamps = dataset.load_images(args.dataset_path,
                                             args.max_frames)
    print(f"Loaded {len(timestamps)} image pairs")

    descs = []
    for fcid in sorted(images):
        _, valid, _, desc = describe.detect_and_describe(
            torch.tensor(images[fcid], device=device),
            num_features=args.num_features)
        descs.append(interop.descriptors_to_numpy(desc)[valid.cpu().numpy()])
    all_desc = np.concatenate(descs)
    print(f"Collected {len(all_desc)} descriptors from {len(images)} images")

    voc = bow.build_vocabulary(all_desc, k=args.branching,
                               levels=args.levels, seed=0)
    voc.save(args.output)
    print(f"Built vocabulary with {voc.num_words} words -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
