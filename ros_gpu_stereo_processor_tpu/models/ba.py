"""Sliding-window bundle adjustment — Gauss–Newton with Schur complement.

The optimisation backend of the SLAM stack (SURVEY.md §7 step 6,
BASELINE.json config 4/5).  Accelerator-first formulation:

  * **fixed-capacity padded window** (M poses × N landmarks, observation
    mask) — XLA static shapes; absent observations carry zero weight
    (SURVEY.md §7 hard parts: "variable-size keyframe/landmark sets vs XLA
    static shapes — fixed-capacity padded windows with masks");
  * all residual/Jacobian/Hessian-block assembly is batched einsums over the
    (M, N) observation grid (batched matrix products);
  * the reduced camera system (Schur complement over landmarks) is a dense
    (6M, 6M) solve — tiny, stays on-chip;
  * Huber IRLS re-weighting per outer iteration, ``lax.scan`` over a fixed
    iteration count;
  * gauge freedom fixed by freezing the first pose.

The landmark-marginalisation sums (Σ over n of W·V⁻¹·Wᵀ …) are exactly the
quantities that shard across devices in the distributed version
(parallel/dist_ba.py): each chip owns a landmark block and the camera system
is psum-reduced across devices.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu.utils import lie


class BAProblem(NamedTuple):
    """Padded BA window.  Poses are world→camera: x_c = R x_w + t."""

    R: jnp.ndarray        # (M, 3, 3)
    t: jnp.ndarray        # (M, 3)
    points: jnp.ndarray   # (N, 3) world landmarks
    obs: jnp.ndarray      # (M, N, 2) pixel observations
    mask: jnp.ndarray     # (M, N) 0/1 observation validity
    fx: float
    cx: float
    cy: float


def reprojection_residuals(p: BAProblem):
    """(M, N, 2) residuals + (M, N, 3) camera-frame points."""
    pc = jnp.einsum("mij,nj->mni", p.R, p.points) + p.t[:, None, :]
    z = jnp.maximum(pc[..., 2], 1e-6)
    u = p.fx * pc[..., 0] / z + p.cx
    v = p.fx * pc[..., 1] / z + p.cy
    r = jnp.stack([u - p.obs[..., 0], v - p.obs[..., 1]], -1)
    return r, pc


def _jacobians(p: BAProblem, pc: jnp.ndarray):
    """J wrt pose tangent ξ_m (M,N,2,6) and wrt landmark X_n (M,N,2,3)."""
    X, Y = pc[..., 0], pc[..., 1]
    Z = jnp.maximum(pc[..., 2], 1e-6)
    iz = 1.0 / Z
    iz2 = iz * iz
    zeros = jnp.zeros_like(iz)
    Ju_p = jnp.stack([p.fx * iz, zeros, -p.fx * X * iz2], -1)   # (M,N,3) d u/d pc
    Jv_p = jnp.stack([zeros, p.fx * iz, -p.fx * Y * iz2], -1)
    Jproj = jnp.stack([Ju_p, Jv_p], -2)                          # (M,N,2,3)

    # pose: left-multiplicative se3 on the world→camera pose:
    # d pc/dρ = I, d pc/dω = −[pc]×
    Pskew = lie.hat(pc)                                          # (M,N,3,3)
    J_pose = jnp.concatenate(
        [Jproj, -jnp.einsum("mnri,mnij->mnrj", Jproj, Pskew)], -1
    )                                                            # (M,N,2,6)
    # landmark: d pc/dX = R_m
    J_point = jnp.einsum("mnri,mij->mnrj", Jproj, p.R)           # (M,N,2,3)
    return J_pose, J_point


def _robust_weights(r: jnp.ndarray, mask: jnp.ndarray, huber_px: float):
    """Huber IRLS weights with adaptive gross-outlier rejection.

    Huber bounds but never zeroes an outlier's influence; enough gross
    outliers still bias GN.  Gate residuals beyond max(8·median, 3·huber) —
    the median adapts so early large-but-genuine residuals (bad initial
    poses) aren't rejected."""
    rn = jnp.linalg.norm(r, axis=-1)
    w = jnp.where(rn <= huber_px, 1.0, huber_px / jnp.maximum(rn, 1e-9))
    med = jnp.nanmedian(jnp.where(mask > 0, rn, jnp.nan))
    gate = jnp.maximum(8.0 * jnp.nan_to_num(med, nan=1e9), 3.0 * huber_px)
    return w * mask * (rn <= gate)


def ba_normal_terms(p: BAProblem, huber_px: float = 3.0):
    """Assemble the GN normal-equation blocks (the shardable quantities).

    Returns (U (M,6,6), V (N,3,3), W (M,N,6,3), b_p (M,6), b_l (N,3))."""
    r, pc = reprojection_residuals(p)
    J_pose, J_point = _jacobians(p, pc)
    w = _robust_weights(r, p.mask, huber_px)                     # (M,N)
    # points at/behind the camera produce exploding Jacobians (J ∝ 1/z²
    # squares again in the Schur product → f32 overflow) — gate them out
    w = w * (pc[..., 2] > 0.05)
    wJp = J_pose * w[..., None, None]
    wJl = J_point * w[..., None, None]

    U = jnp.einsum("mnri,mnrj->mij", wJp, J_pose)                # (M,6,6)
    V = jnp.einsum("mnri,mnrj->nij", wJl, J_point)               # (N,3,3)
    Wb = jnp.einsum("mnri,mnrj->mnij", wJp, J_point)             # (M,N,6,3)
    b_p = jnp.einsum("mnri,mnr->mi", wJp, r)                     # (M,6)
    b_l = jnp.einsum("mnri,mnr->ni", wJl, r)                     # (N,3)
    return U, V, Wb, b_p, b_l


def schur_solve(U, V, Wb, b_p, b_l, damping: float = 1e-4,
                fix_first_pose: bool = True,
                point_prior: jnp.ndarray | None = None):
    """Marginalise landmarks, solve the reduced camera system, back-substitute.

    ``point_prior`` (N,): extra diagonal weight per landmark — large values
    freeze landmarks (gauge/scale anchoring, e.g. stereo-triangulated points).
    Returns (dxi (M,6), dX (N,3))."""
    M = U.shape[0]
    N = V.shape[0]
    eye3 = jnp.eye(3)
    # damping relative to each block's scale: an under-observed landmark has
    # a rank-deficient V whose near-zero eigenvalue must be lifted *relative*
    # to the block magnitude or the f32 inverse degenerates
    tr = jnp.trace(V, axis1=-2, axis2=-1)[:, None, None] / 3.0
    Vd = V + (damping * (1.0 + tr) + 1e-8) * eye3[None]
    if point_prior is not None:
        Vd = Vd + point_prior[:, None, None] * eye3[None]
    Vinv = jnp.linalg.inv(Vd)                                    # (N,3,3)

    WVinv = jnp.einsum("mnij,njk->mnik", Wb, Vinv)               # (M,N,6,3)
    # S_{mk} = δ_mk U_m − Σ_n WVinv_{mn} W_{kn}ᵀ
    S_off = jnp.einsum("mnik,lnjk->mlij", WVinv, Wb)             # (M,M,6,6)
    S = -S_off
    S = S.at[jnp.arange(M), jnp.arange(M)].add(U + damping * jnp.eye(6)[None])
    rhs = b_p - jnp.einsum("mnik,nk->mi", WVinv, b_l)            # (M,6)

    Sd = S.transpose(0, 2, 1, 3).reshape(6 * M, 6 * M)
    rhsd = rhs.reshape(-1)
    if fix_first_pose:
        # gauge: hard-eliminate pose 0 (identity rows/cols, zero rhs) —
        # well-conditioned in f32, unlike a huge soft prior
        mask = (jnp.arange(6 * M) >= 6).astype(Sd.dtype)
        Sd = Sd * mask[:, None] * mask[None, :]
        Sd = Sd + jnp.diag(1.0 - mask)
        rhsd = rhsd * mask
    dxi = -jnp.linalg.solve(Sd, rhsd).reshape(M, 6)

    # back-substitute landmarks: dX = −V⁻¹ (b_l + Σ_m W_{mn}ᵀ dξ_m)
    WtD = jnp.einsum("mnij,mi->nj", Wb, dxi)                     # (N,3)
    dX = -jnp.einsum("nij,nj->ni", Vinv, b_l + WtD)
    return dxi, dX


def clip_step(dxi: jnp.ndarray, dX: jnp.ndarray, max_norm: float = 0.5):
    """Trust-region guard: scale down any per-pose/per-point update whose
    norm exceeds ``max_norm`` (plain GN can overshoot under heavy outliers
    before the IRLS weights adapt)."""

    def clip(v):
        n = jnp.linalg.norm(v, axis=-1, keepdims=True)
        return v * jnp.minimum(1.0, max_norm / jnp.maximum(n, 1e-12))

    return clip(dxi), clip(dX)


def apply_update(p: BAProblem, dxi: jnp.ndarray, dX: jnp.ndarray) -> BAProblem:
    dR, dt = lie.se3_exp(dxi)
    Rn = jnp.einsum("mij,mjk->mik", dR, p.R)
    tn = jnp.einsum("mij,mj->mi", dR, p.t) + dt
    return p._replace(R=Rn, t=tn, points=p.points + dX)


@functools.partial(jax.jit, static_argnames=("iters", "fix_first_pose"))
def bundle_adjust(
    p: BAProblem,
    iters: int = 10,
    huber_px: float = 3.0,
    damping: float = 1e-4,
    fix_first_pose: bool = True,
    point_prior: jnp.ndarray | None = None,
) -> tuple[BAProblem, jnp.ndarray]:
    """Run fixed-iteration Gauss–Newton BA.  Returns (refined problem,
    rms history (iters+1,)).

    Note on gauge: monocular reprojection alone leaves global scale free;
    pass ``point_prior`` with large weights on a few well-triangulated
    (e.g. stereo-depth) landmarks to anchor it, as models/slam.py does.
    """

    def rms(prob):
        r, _ = reprojection_residuals(prob)
        w = prob.mask
        return jnp.sqrt(
            jnp.sum(jnp.sum(r * r, -1) * w) / jnp.maximum(jnp.sum(w), 1.0)
        )

    def step(prob, _):
        U, V, Wb, b_p, b_l = ba_normal_terms(prob, huber_px)
        dxi, dX = schur_solve(
            U, V, Wb, b_p, b_l, damping, fix_first_pose, point_prior
        )
        dxi, dX = clip_step(dxi, dX)
        return apply_update(prob, dxi, dX), rms(prob)

    # f32 matmuls on the GPU default to TF32 inputs (10-bit mantissa),
    # which destabilises Gauss-Newton — force true f32
    with jax.default_matmul_precision("highest"):
        pf, hist = jax.lax.scan(step, p, None, length=iters)
        return pf, jnp.append(hist, rms(pf))
