"""Camera calibration app (reference: src/calibration.cpp).

    python -m photometric_bundle_adjustment_tpu_torch.apps.calibrate \\
        --dataset-path /path/to/euroc_calib --cam-model kb4 [--device cuda|cpu]

Port of ``photometric_bundle_adjustment_tpu/apps/calibrate.py``, headless:
loads the detected AprilGrid corners, the initial poses and the
double-sphere initial intrinsics from a dataset directory, runs the
full-batch NLLS (``models/calibration.py``) in f64 on ``--device`` (the
card by default: the H100 computes f64 natively, where the JAX app
defaulted to the CPU), and writes ``opt_calib.json`` in the reference's
cereal JSON layout for the sfm app of either package or the reference.
The image sizes in the header come from the first image of each camera,
read with PIL where it is installed, else 0.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="AprilGrid camera calibration")
    parser.add_argument("--dataset-path", required=True)
    parser.add_argument(
        "--cam-model", default="ds",
        help="Camera model: pinhole, ds, eucm, kb4. Default: ds.")
    parser.add_argument("--show-gui", default="false",
                        help="Accepted for CLI parity; this app is headless.")
    parser.add_argument("--output", default="opt_calib.json")
    parser.add_argument("--max-iterations", type=int, default=50)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import torch

    from photometric_bundle_adjustment_tpu_torch import device as devices
    from photometric_bundle_adjustment_tpu_torch.core import cameras
    from photometric_bundle_adjustment_tpu_torch.io import calib_io
    from photometric_bundle_adjustment_tpu_torch.models import (
        calibration as calib_model,
    )

    if args.cam_model not in cameras.MODELS:
        parser.error(
            f"Camera model {args.cam_model!r} is not implemented. "
            f"Available: {sorted(cameras.MODELS)}")
    dev = devices.resolve(args.device)

    ds = args.dataset_path
    poses = calib_io.load_init_poses(os.path.join(ds, "init_poses.json"))
    corners = calib_io.load_detected_corners(
        os.path.join(ds, "detected_corners.json"))
    init_calib = calib_io.load_ds_calibration(
        os.path.join(ds, "calibration-double-sphere.json"))
    print(f"Loaded {len(poses)} poses")
    print(f"Loaded {len(corners)} corners")
    print("Loaded camera")

    num_cams = init_calib.num_cams
    frame_ids = sorted({f for (f, _) in corners})
    F = len(frame_ids)

    # initial body poses from cam-0 init poses (calibration.cpp:322-326)
    T_w_i0 = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (F, 1))
    for i, f in enumerate(frame_ids):
        if (f, 0) in poses:
            T_w_i0[i] = poses[(f, 0)]
    intr0 = np.stack([
        cameras.initialize(args.cam_model,
                           torch.as_tensor(init_calib.intrinsics[c])).numpy()
        for c in range(num_cams)])

    # image sizes (for the saved calibration's header)
    widths, heights = [0] * num_cams, [0] * num_cams
    try:
        from PIL import Image

        for (f, c) in sorted(corners):
            if widths[c] == 0:
                img_path = os.path.join(ds, f"{f}_{c}.jpg")
                if os.path.exists(img_path):
                    with Image.open(img_path) as im:
                        widths[c], heights[c] = im.size
    except ImportError:
        pass

    data = calib_model.build_data(corners, frame_ids,
                                  calib_model.aprilgrid_corners_3d(),
                                  device=dev)

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    init = calib_model.CalibParams(T_w_i=put(T_w_i0),
                                   T_i_c=put(init_calib.T_i_c),
                                   intrinsics=put(intr0))
    n_res = data.uv.shape[0] * 2
    print(f"Optimizing {F} frames x {num_cams} cams, model={args.cam_model}, "
          f"{n_res} residuals, {F * 6 + num_cams * 14} tangent dims "
          f"on {dev}")
    t0 = time.time()
    params, res = calib_model.calibrate(args.cam_model, data, init,
                                        args.max_iterations)
    dt = time.time() - t0
    rmse = float(np.sqrt(2.0 * float(res.cost) / n_res))
    print(f"Converged in {int(res.iterations)} iterations, {dt:.2f}s: "
          f"cost {float(res.initial_cost):.6e} -> {float(res.cost):.6e}, "
          f"reprojection RMSE {rmse:.4f} px")

    out = calib_io.Calibration(
        T_i_c=params.T_i_c.cpu().numpy(),
        intrinsics=params.intrinsics.cpu().numpy(),
        cam_types=[args.cam_model] * num_cams,
        widths=widths, heights=heights)
    calib_io.save_calibration(args.output, out)
    print(f"Saved camera calibration to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
