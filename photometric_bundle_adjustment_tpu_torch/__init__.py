"""photometric_bundle_adjustment_tpu_torch — the photometric bundle
adjustment solve in PyTorch, with its per-observation megakernel written
in CUDA C++ for Hopper (sm_90a).

The package mirrors the module paths of ``photometric_bundle_adjustment_tpu``
(the JAX reference) for the slice it covers:

- ``core``      SE3 quaternion ops, the four camera models and the
                plane-layout projection with its analytic Jacobian.
- ``optim``     the BA types, the host-side chunk plans and the chunked
                segment sum.
- ``models``    the photometric problem, samplers, image pyramid and the
                synthetic problem / pipe generators.
- ``ops``       the photometric megakernel (``pba_mega``) with its plain
                PyTorch version, and the kernel builder.
- ``pipeline``  ``refine_photometric``: coarse-to-fine photometric BA of a
                map.

It imports torch and numpy only: never ``jax``, and never the JAX package.
Every entry point takes an explicit ``device``.
"""

__version__ = "0.1.0"
