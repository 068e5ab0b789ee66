"""photometric_bundle_adjustment_tpu_torch — the photometric bundle
adjustment solve and the SfM front end in PyTorch, with their kernels
written in CUDA C++ for Hopper (sm_90a).

The package mirrors the module paths of ``photometric_bundle_adjustment_tpu``
(the JAX reference) for the slices it covers:

- ``core``      SE3 quaternion ops, the four camera models and the
                plane-layout projection with its analytic Jacobian.
- ``features``  Shi-Tomasi detection, rotated BRIEF descriptors, Hamming
                matching with the ratio test and mutual check, all-pairs
                matching over a pair worklist, the epipolar test.
- ``optim``     the BA types, the host-side chunk plans, the chunked
                segment sum and the fixed-order sums (``tree_sum``) that
                make a build repeat bit for bit.
- ``models``    the photometric problem, samplers, image pyramid and the
                synthetic problem, map and stereo-sequence generators.
- ``ops``       the photometric megakernel (``pba_mega``: warp, sampling
                and Schur payloads of every observation column), the
                patch sampler (``patch_sample``) and the Hamming best-two
                matcher (``hamming``), each with its plain PyTorch
                version, and the kernel builder.
- ``pipeline``  ``refine_photometric`` (coarse-to-fine photometric BA of a
                map), ``SfmPipeline``'s front-end stages and ``SfmConfig``.

It imports torch and numpy only: never ``jax``, and never the JAX package.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, and raise where CUDA is absent.
"""

__version__ = "0.1.0"
