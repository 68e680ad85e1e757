"""Plain numpy references for the dense stages, written from the algorithms'
definitions (loops over disparities and scan lines, float64 sums) — the
oracles the jnp ops are tested against on the CPU.

Costs of uint8-derived images are integer-valued, so BM and SGM winners
compare exactly; float outputs (subpixel, interpolation) by tolerance.
"""

from __future__ import annotations

import numpy as np

BIG = 1e9


def xsobel(img: np.ndarray, cap: int = 31) -> np.ndarray:
    """OpenCV PREFILTER_XSOBEL: 3-row-weighted horizontal difference,
    rows replicated at the border, clamped to [0, 2·cap], neutral (cap)
    first/last column."""
    x = img.astype(np.float64)
    xp = np.pad(x, ((1, 1), (0, 0)), mode="edge")
    rows = xp[:-2] + 2.0 * xp[1:-1] + xp[2:]
    d = np.zeros_like(x)
    d[:, 1:-1] = rows[:, 2:] - rows[:, :-2]
    out = np.clip(d + cap, 0.0, 2.0 * cap)
    out[:, 0] = out[:, -1] = cap
    return out


def box_sum(x: np.ndarray, block: int) -> np.ndarray:
    """block×block window sum, zero outside the image (integral image)."""
    r = block // 2
    H, W = x.shape
    c = np.pad(np.pad(x, r), ((1, 0), (1, 0))).cumsum(0).cumsum(1)
    return (c[block:block + H, block:block + W] - c[:H, block:block + W]
            - c[block:block + H, :W] + c[:H, :W])


def sad_cost(lf: np.ndarray, rf: np.ndarray, cfg) -> np.ndarray:
    """(nd, H, W): Σ_window |L(x) − R(x − d)|, BIG where the right window
    would leave the image."""
    H, W = lf.shape
    r = cfg.block_radius
    x = np.arange(W)[None, :]
    cost = np.empty((cfg.num_disparities, H, W))
    for k in range(cfg.num_disparities):
        d = cfg.min_disparity + k
        shifted = np.zeros_like(rf)
        src = x[0] - d
        ok = (src >= 0) & (src < W)
        shifted[:, ok] = rf[:, src[ok]]
        sad = box_sum(np.abs(lf - shifted), cfg.block_size)
        fits = (x - d >= r) & (x - d <= W - 1 - r)
        cost[k] = np.where(fits, sad, BIG)
    return cost


def wta(cost: np.ndarray, lf: np.ndarray, cfg):
    """Winner-take-all with border, texture and uniqueness validity and
    parabolic subpixel refinement (f32 arithmetic, as on the device)."""
    nd, H, W = cost.shape
    r, mind = cfg.block_radius, cfg.min_disparity
    best = np.argmin(cost, axis=0)
    cbest = cost.min(axis=0)
    yy, xx = np.mgrid[0:H, 0:W]
    valid = ((cbest < BIG) & (yy >= r) & (yy <= H - 1 - r)
             & (xx >= r) & (xx <= W - 1 - r))
    if cfg.texture_threshold > 0:
        tex = box_sum(np.abs(lf - cfg.prefilter_cap), cfg.block_size)
        valid &= tex >= cfg.texture_threshold
    if cfg.uniqueness_ratio > 0:
        thresh = cbest.astype(np.float32) * np.float32(
            1.0 + cfg.uniqueness_ratio / 100.0)
        far = np.abs(np.arange(nd)[:, None, None] - best[None]) > 1
        valid &= ~np.any((cost <= thresh[None]) & far, axis=0)
    disp = (best + mind).astype(np.float32)
    if cfg.refine_disparity:
        take = lambda i: np.take_along_axis(cost, i[None], 0)[0].astype(np.float32)
        cm = take(np.clip(best - 1, 0, nd - 1))
        cp = take(np.clip(best + 1, 0, nd - 1))
        c0 = cbest.astype(np.float32)
        denom = cm + cp - np.float32(2.0) * c0
        with np.errstate(divide="ignore", invalid="ignore"):
            delta = np.where(denom > 0, (cm - cp) / (np.float32(2.0) * denom),
                             np.float32(0.0))
        delta = np.clip(delta, -0.5, 0.5).astype(np.float32)
        interior = (best > 0) & (best < nd - 1) & (cm < BIG) & (cp < BIG)
        disp = disp + np.where(interior, delta, np.float32(0.0))
    return np.where(valid, disp, np.float32(mind - 1)), valid


def right_disparity(cost: np.ndarray, cfg) -> np.ndarray:
    """Right-image WTA from the left-indexed volume: candidates of right
    pixel xr are cost[d, y, xr + mind + d]; first minimum wins."""
    nd, H, W = cost.shape
    mind = cfg.min_disparity
    xr = np.arange(W)
    best = np.full((H, W), BIG)
    bestd = np.full((H, W), -1)
    for k in range(nd):
        x = xr + mind + k
        ok = (x >= 0) & (x < W)
        plane = np.full((H, W), BIG)
        plane[:, ok] = cost[k][:, x[ok]]
        better = plane < best
        best = np.where(better, plane, best)
        bestd = np.where(better, k, bestd)
    return np.where(best < BIG, bestd + mind, mind - 1).astype(np.float32)


def left_right_check(disp_l, disp_r, cfg) -> np.ndarray:
    H, W = disp_l.shape
    dl = np.round(disp_l).astype(np.int64)
    inrange = (dl >= cfg.min_disparity) & (
        dl < cfg.min_disparity + cfg.num_disparities)
    at = np.take_along_axis(disp_r, (np.arange(W)[None] - dl) % W, axis=1)
    return inrange & (np.abs(at - disp_l) <= cfg.lr_max_diff)


def _finish(cost, lf, cfg):
    disp, valid = wta(cost, lf, cfg)
    if cfg.lr_check:
        valid &= left_right_check(disp, right_disparity(cost, cfg), cfg)
        disp = np.where(valid, disp, np.float32(cfg.min_disparity - 1))
    return disp, valid


def block_match(left, right, cfg):
    """Full BM pass (xsobel prefilter): (disparity f32, valid)."""
    lf, rf = xsobel(left, cfg.prefilter_cap), xsobel(right, cfg.prefilter_cap)
    return _finish(sad_cost(lf, rf, cfg), lf, cfg)


def _aggregate(cost, axis, reverse, p1, p2):
    """One SGM path direction over (H, W, nd), scanning ``axis``:
    L(p,d) = C(p,d) + min(L', L'(d±1)+P1, min L'+P2) − min L'."""
    seq = np.moveaxis(cost, axis, 0)
    out = np.empty_like(seq)
    order = range(seq.shape[0] - 1, -1, -1) if reverse else range(seq.shape[0])
    prev = None
    for i in order:
        if prev is None:
            cur = seq[i].copy()
        else:
            m = prev.min(-1, keepdims=True)
            cand = np.minimum(prev, m + p2)
            cand[..., :-1] = np.minimum(cand[..., :-1], prev[..., 1:] + p1)
            cand[..., 1:] = np.minimum(cand[..., 1:], prev[..., :-1] + p1)
            cur = seq[i] + (cand - m)
        out[i] = prev = cur
    return np.moveaxis(out, 0, axis)


def sgm(left, right, cfg, p1=10.0, p2=120.0):
    """4-path SGM over the SAD volume, then the BM winner/validity rules."""
    lf, rf = xsobel(left, cfg.prefilter_cap), xsobel(right, cfg.prefilter_cap)
    cost = sad_cost(lf, rf, cfg)
    invalid = cost >= BIG
    chw = np.moveaxis(np.where(invalid, 2.0 * p2 + 255.0 * cfg.block_size**2,
                               cost), 0, -1)
    agg = sum(_aggregate(chw, axis, rev, p1, p2)
              for axis in (1, 0) for rev in (False, True))
    return _finish(np.where(invalid, BIG, np.moveaxis(agg, -1, 0)), lf, cfg)


def remap_bilinear(img: np.ndarray, src_map: np.ndarray) -> np.ndarray:
    """Bilinear sampling at (x, y) = src_map, each tap zero outside the
    image; integer images rounded and clipped."""
    H, W = img.shape[:2]
    x, y = src_map[..., 0].astype(np.float64), src_map[..., 1].astype(np.float64)
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    fx, fy = x - x0, y - y0
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    out = 0.0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yi, xi = y0 + dy, x0 + dx
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            v = img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)].astype(np.float64)
            if img.ndim == 3:
                ok = ok[..., None]
            out = out + np.where(ok, v, 0.0) * wx * wy
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.round(out), info.min, info.max)
    return out.astype(img.dtype)


def component_labels(disp: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """scipy.ndimage.label components (4-connected) of each disparity value
    among valid pixels — the speckle components when disparities are
    quantized farther apart than max_diff.  Returns labels 1..n, 0 where
    invalid."""
    from scipy import ndimage

    out = np.zeros(disp.shape, np.int64)
    n = 0
    for v in np.unique(disp[valid]):
        lab, k = ndimage.label(valid & (disp == v))
        out[lab > 0] = lab[lab > 0] + n
        n += k
    return out


def min_index_labels(labels: np.ndarray) -> np.ndarray:
    """Each component's smallest flat pixel index (the label min-propagation
    converges to); H·W where invalid."""
    from scipy import ndimage

    H, W = labels.shape
    idx = np.arange(H * W).reshape(H, W)
    n = labels.max()
    mins = np.asarray(ndimage.minimum(idx, labels, np.arange(1, n + 1)))
    return np.where(labels > 0, np.concatenate([[H * W], mins])[labels],
                    H * W).astype(np.int64)
