"""The compile-check step of the flagship model, on the card.

The port's counterpart of the JAX package's ``__graft_entry__.entry``: one
forward step of photometric bundle adjustment (patch-warp intensity
residuals, Jacobians by forward mode through the retraction, the
scatter-add normal equations and one Schur-LM step) on
``synth_pba_problem(K=4, L=256)`` in float32.
"""

from __future__ import annotations

from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.optim import ba


def entry(device="cuda"):
    """``(step, (problem,))``: ``step(problem) -> (cost, delta_c (4, 8),
    delta_p (256,))`` with ``make_ba_step``'s forward-mode Jacobians
    (``rj_fn=None``), Huber 9 and ``schur_solve`` at lambda = 1e-4."""
    problem, images_flat, H, W, _, _ = synthetic.synth_pba_problem(
        K=4, L=256, device=device)
    cfg = ba.BAConfig(max_iterations=1, huber_delta=9.0)
    residual_fn = pba.make_residual_fn("pinhole", images_flat, H, W)
    _, build_neq = ba.make_ba_step(residual_fn, pba.cam_retract, 8)

    def step(problem):
        with ba.full_f32():
            cost, H_cc, H_cp, H_pp, g_c, g_p = build_neq(problem, cfg)
            dc, dp = ba.schur_solve(H_cc, H_cp, H_pp, g_c, g_p, 1e-4,
                                    ~problem.fixed_cams, problem.lm_valid, cfg)
        return cost, dc, dp

    return step, (problem,)
