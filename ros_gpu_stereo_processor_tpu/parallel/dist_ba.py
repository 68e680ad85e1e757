"""Distributed bundle adjustment — landmark/map-block partitioning.

The multi-host optimisation backend (SURVEY.md §5.8, BASELINE.json config 5):
landmarks (map blocks) are sharded across the mesh; each chip assembles the
Gauss–Newton normal-equation contributions of its landmark block, the reduced
camera system is **psum-reduced across devices**, every chip solves the identical
(tiny, 6M×6M) system, and landmark updates back-substitute locally — the
Schur-complement reduction over collectives called for by the north star.

Communication per iteration: one psum of (M·6·M·6 + M·6) floats — independent
of the number of landmarks.  Numerically identical to models/ba.py (modulo
f32 reduction order); tests enforce tight agreement on a CPU mesh.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ros_gpu_stereo_processor_tpu.models import ba as BA
from ros_gpu_stereo_processor_tpu.models.ba import BAProblem
from ros_gpu_stereo_processor_tpu.utils import lie


def bundle_adjust_sharded(
    p: BAProblem,
    mesh: Mesh,
    axis: str = "kf",
    iters: int = 10,
    huber_px: float = 3.0,
    damping: float = 1e-4,
    fix_first_pose: bool = True,
    point_prior: jnp.ndarray | None = None,
) -> Tuple[BAProblem, jnp.ndarray]:
    """Landmark-sharded BA.  Same contract as models/ba.bundle_adjust; the
    landmark axis N must divide the mesh axis size."""
    N = p.points.shape[0]
    n_dev = mesh.shape[axis]
    if N % n_dev != 0:
        raise ValueError(f"N={N} landmarks not divisible by mesh axis {axis}={n_dev}")
    prior = point_prior if point_prior is not None else jnp.zeros((N,))

    M = p.R.shape[0]

    def shard_fn(R, t, points, obs, mask, prior_l):
        # local problem: full poses, local landmark block
        def one_iter(carry, _):
            R, t, points = carry
            prob = BAProblem(R=R, t=t, points=points, obs=obs, mask=mask,
                             fx=p.fx, cx=p.cx, cy=p.cy)
            U_l, V_l, W_l, bp_l, bl_l = BA.ba_normal_terms(prob, huber_px)

            eye3 = jnp.eye(3)
            tr = jnp.trace(V_l, axis1=-2, axis2=-1)[:, None, None] / 3.0
            Vd = V_l + (damping * (1.0 + tr) + 1e-8) * eye3[None]
            Vd = Vd + prior_l[:, None, None] * eye3[None]
            Vinv = jnp.linalg.inv(Vd)

            WVinv = jnp.einsum("mnij,njk->mnik", W_l, Vinv)
            S_off = jnp.einsum("mnik,lnjk->mlij", WVinv, W_l)
            rhs_l = bp_l - jnp.einsum("mnik,nk->mi", WVinv, bl_l)

            # ---- the only cross-chip communication: reduce the camera system
            S = jax.lax.psum(-S_off, axis)
            U = jax.lax.psum(U_l, axis)
            rhs = jax.lax.psum(rhs_l, axis)
            # ----

            S = S.at[jnp.arange(M), jnp.arange(M)].add(
                U + damping * jnp.eye(6)[None]
            )
            Sd = S.transpose(0, 2, 1, 3).reshape(6 * M, 6 * M)
            rhsd = rhs.reshape(-1)
            if fix_first_pose:
                gmask = (jnp.arange(6 * M) >= 6).astype(Sd.dtype)
                Sd = Sd * gmask[:, None] * gmask[None, :]
                Sd = Sd + jnp.diag(1.0 - gmask)
                rhsd = rhsd * gmask
            dxi = -jnp.linalg.solve(Sd, rhsd).reshape(M, 6)

            WtD = jnp.einsum("mnij,mi->nj", W_l, dxi)
            dX = -jnp.einsum("nij,nj->ni", Vinv, bl_l + WtD)
            dxi, dX = BA.clip_step(dxi, dX)

            dR, dt = lie.se3_exp(dxi)
            Rn = jnp.einsum("mij,mjk->mik", dR, R)
            tn = jnp.einsum("mij,mj->mi", dR, t) + dt
            # local masked rms contribution
            r, _ = BA.reprojection_residuals(prob)
            sq = jax.lax.psum(jnp.sum(jnp.sum(r * r, -1) * mask), axis)
            cnt = jax.lax.psum(jnp.sum(mask), axis)
            return (Rn, tn, points + dX), jnp.sqrt(sq / jnp.maximum(cnt, 1.0))

        # force true-f32 matmuls (the GPU default rounds inputs to TF32 —
        # GN diverges)
        with jax.default_matmul_precision("highest"):
            (Rf, tf, ptsf), hist = jax.lax.scan(
                one_iter, (R, t, points), None, length=iters
            )
            # final post-update rms so hist has iters+1 entries like the
            # single-device bundle_adjust
            prob_f = BAProblem(R=Rf, t=tf, points=ptsf, obs=obs, mask=mask,
                               fx=p.fx, cx=p.cx, cy=p.cy)
            r_f, _ = BA.reprojection_residuals(prob_f)
            sq_f = jax.lax.psum(jnp.sum(jnp.sum(r_f * r_f, -1) * mask), axis)
            cnt_f = jax.lax.psum(jnp.sum(mask), axis)
            hist = jnp.append(hist, jnp.sqrt(sq_f / jnp.maximum(cnt_f, 1.0)))
        return Rf, tf, ptsf, hist

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(None, axis), P(None, axis), P(axis)),
        out_specs=(P(), P(), P(axis), P()),
        check_vma=False,
    )
    Rf, tf, ptsf, hist = fn(p.R, p.t, p.points, p.obs, p.mask, prior)
    pf = p._replace(R=Rf, t=tf, points=ptsf)
    return pf, hist
