"""photometric_bundle_adjustment_tpu_torch — the photometric and geometric
bundle adjustment solves and the SfM front end in PyTorch, with their
kernels written in CUDA C++ for Hopper (sm_90a).

The package mirrors the module paths of ``photometric_bundle_adjustment_tpu``
(the JAX reference) for the slices it covers:

- ``core``      SE3 quaternion ops, the four camera models (and the
                reference's test intrinsics) and the plane-layout
                projection with its analytic Jacobian.
- ``features``  Shi-Tomasi detection, rotated BRIEF descriptors, Hamming
                matching with the ratio test and mutual check, all-pairs
                matching over a pair worklist, two-view geometry, the
                five-point (``nister``) and P3P (``p3p``) minimal solvers,
                batched relative-pose and PnP RANSAC (``ransac``), the
                pair matcher's RANSAC half, bag-of-words (``bow``).
- ``optim``     the BA types, the scatter-add reference step, Schur solve
                and solver (``ba``), the shared LM loops, the host-side
                chunk plans, the plan-based fused solver with the
                forward-mode Jacobian default (``fused``), the fixed-order
                sums (``tree_sum``) that make a build repeat bit for bit,
                and the generic manifold LM (``lm``, with a batched form
                for RANSAC's refinements).
- ``models``    the photometric problem, samplers, image pyramid and
                solvers; the geometric (reprojection) problem, its
                closed-form Jacobian and ``bundle_adjustment``
                (``geometric_ba``); the synthetic problem, map and
                stereo-sequence generators.
- ``ops``       the photometric megakernel (``pba_mega``: warp, sampling
                and Schur payloads of every observation column), the
                patch sampler (``patch_sample``) and the Hamming best-two
                matcher (``hamming``), each with its plain PyTorch
                version, and the kernel builder; the plane-layout
                geometric builds (``geo_mega``, no kernel).
- ``pipeline``  ``refine_photometric`` (coarse-to-fine photometric BA of a
                map), ``SfmPipeline``'s front-end stages (detection,
                stereo matching, ``match_all`` and ``match_bow`` with
                RANSAC), a saved map (``from_map``) and its geometric BA
                problem, and ``SfmConfig``.
- ``io``        the calibration JSON loader (``calib_io``), the reference's
                binary-cereal artifacts (``cereal_io``).
- ``utils``     Umeyama alignment and trajectory error (``evaluation``).
- ``entry``     the compile-check step of the flagship model.

It imports torch and numpy only: never ``jax``, and never the JAX package.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, and raise where CUDA is absent.
"""

__version__ = "0.1.0"
