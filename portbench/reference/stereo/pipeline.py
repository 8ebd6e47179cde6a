"""Per-level and per-pair stereo drivers (counterpart of
`reconstruction_tpu/stereo/pipeline.py`).

Per level and direction, in the reference's stage order
(`CStereoMatching.cpp:36-113`):

  brute (level 0) or guided match -> smoothness -> ordering -> uniqueness
  -> bound propagation + rematch -> uniqueness -> median -> refine
  (30 + 30*level sweeps) -> uniqueness

and per pair (`MatchAllLayer`): rectify -> remap -> mask erosion ->
pyramids -> levels coarse to fine -> triangulation.  Everything image
sized runs on the ``device`` given to `match_pair`, in plain PyTorch: the
sweeps, the cost volume, the refine sweeps and the constraint passes are
the plain versions of the port's kernels on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from portbench.reference.config import NOMATCH, ReconstructionConfig
from portbench.reference.core.morphology import erode_mask, valid_mask
from portbench.reference.core.pyramid import build_pyramid, quantize_u8
from portbench.reference.core.rectify import RectifyResult, rectify_pair
from portbench.reference.core.remap import rectify_map, remap_bilinear
from portbench.reference.stereo.constraints import (
    median_filter, ordering_constraint, propagate_bounds,
    smoothness_constraint, uniqueness_constraint)
from portbench.reference.stereo.margins import Margins, find_margin
from portbench.reference.stereo.matching import (
    brute_force_match, guided_match, rematch)
from portbench.reference.stereo.refine import disparity_refine
from portbench.reference.stereo.triangulate import (
    PointCloud, disparity_to_cloud)


class LevelState(NamedTuple):
    """Both-direction disparities after one pyramid level."""

    disp0: torch.Tensor  # view0 -> view1
    disp1: torch.Tensor  # view1 -> view0
    # Refine drift telemetry: p99 of |d_refined - d_pre_refine| over
    # pixels valid in both (0-d tensors, slots).
    refine_drift0: Optional[torch.Tensor] = None
    refine_drift1: Optional[torch.Tensor] = None


def _drift(pre: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    """p99 of |post - pre| over pixels valid in both: invalid entries sit
    at 0, so it is the all-pixel percentile at 100 - valid_fraction
    (linear interpolation, like jnp.percentile)."""
    ok = (pre != NOMATCH) & (post != NOMATCH)
    mag = torch.where(ok, (post - pre).abs(), torch.zeros_like(pre))
    frac = ok.float().mean()
    q = ((100.0 - frac) / 100.0).clamp(0.0, 1.0)
    return torch.quantile(mag.flatten(), q)


def match_one_level(
    img0: torch.Tensor,
    img1: torch.Tensor,
    mask0: torch.Tensor,
    mask1: torch.Tensor,
    coarse: Optional[LevelState],
    level: int,
    radius: int = 2,
    offset: int = 2,
    ws: float = 0.03,
    refine_iters: int = 30,
    median_iters: int = 1,
    s_cap: int = 128,
    recenter_every: int = -1,
) -> LevelState:
    """One pyramid level for both directions (`MatchOneLayer`,
    `CStereoMatching.cpp:36-113`).  The directions run one after the
    other, like the reference's back-to-back calls; the uniqueness passes
    couple them.  The refine's cost volume is float32, as the
    configurations state (`stereo.refine_cv_dtype`); the reference has no
    other."""
    v0, v1 = valid_mask(mask0), valid_mask(mask1)
    m0, m1 = find_margin(v0, radius), find_margin(v1, radius)
    lanes = ((img0, img1, v0, v1, m0, m1), (img1, img0, v1, v0, m1, m0))

    ds = []
    for lane, (ai, bi, av, bv, am, bm) in enumerate(lanes):
        if level == 0:
            d = brute_force_match(ai, bi, av, bv, am, bm, radius)
        else:
            assert coarse is not None
            ac = coarse.disp0 if lane == 0 else coarse.disp1
            d = guided_match(ai, bi, av, bv, ac, am, bm, radius, offset)
        d = smoothness_constraint(d, am)
        ds.append(ordering_constraint(d, am))
    d0, d1 = uniqueness_constraint(ds[0], ds[1], m0, m1)

    ds = []
    for (ai, bi, av, bv, am, bm), d in zip(lanes, (d0, d1)):
        bl, br = propagate_bounds(d, av, am, bm)
        ds.append(rematch(ai, bi, av, bv, d, bl, br, am, radius))
    d0, d1 = uniqueness_constraint(ds[0], ds[1], m0, m1)

    ds, drifts = [], []
    for (ai, bi, av, bv, am, bm), d in zip(lanes, (d0, d1)):
        d = median_filter(d, av, am, median_iters)
        out = disparity_refine(d, ai, bi, am, refine_iters, ws, s_cap,
                               recenter_every=recenter_every)
        ds.append(out)
        drifts.append(_drift(d, out))
    d0, d1 = uniqueness_constraint(ds[0], ds[1], m0, m1)
    return LevelState(disp0=d0, disp1=d1,
                      refine_drift0=drifts[0], refine_drift1=drifts[1])


@dataclass
class PairResult:
    """Output of one camera pair; tensors stay on the pair's device."""

    disparity: torch.Tensor          # finest view0->view1 disparity, f32
    cloud: PointCloud
    rectification: RectifyResult
    margins0: Margins
    margins1: Margins
    # Rectified working-resolution images and pre-erosion masks (uint8).
    rect_images: Tuple[torch.Tensor, torch.Tensor] = None
    rect_masks: Tuple[torch.Tensor, torch.Tensor] = None
    # Per-level refine drift, (levels, 2 directions) slots.
    refine_drift: torch.Tensor = None
    # Eroded rectified masks (uint8), for the cross-view dedup.
    rect_masks_eroded: Tuple[torch.Tensor, torch.Tensor] = None
    # Milliseconds per pyramid level, from CUDA events (CUDA devices only).
    level_ms: Optional[List[float]] = None


def remap_pair_views(
    cfg: ReconstructionConfig,
    image0: np.ndarray,
    image1: np.ndarray,
    mask0: np.ndarray,
    mask1: np.ndarray,
    K0: np.ndarray,
    K1: np.ndarray,
    rect: RectifyResult,
    working: Tuple[int, int],
    device: torch.device,
):
    """Remap both views to the rectified working grid on ``device``
    (`CStereoMatching.cpp:140-158`).  Returns (images on the uint8 grid,
    eroded masks, pre-erosion masks), float32 tensors."""
    se = cfg.stereo.mask_erode_base * (1 << (cfg.pyramid_levels - 1))
    imgs, masks, raw_masks = [], [], []
    for img, msk, K, Rr, P in ((image0, mask0, K0, rect.R1, rect.P1_scaled),
                               (image1, mask1, K1, rect.R2, rect.P2_scaled)):
        mx, my = rectify_map(K, Rr, P, working)
        mx = torch.from_numpy(mx).to(device)
        my = torch.from_numpy(my).to(device)
        im = remap_bilinear(torch.from_numpy(np.asarray(img, np.float32)).to(device),
                            mx, my)
        mk = remap_bilinear(torch.from_numpy(np.asarray(msk, np.float32)).to(device),
                            mx, my)
        raw_masks.append(mk)
        imgs.append(quantize_u8(im))
        masks.append(erode_mask(mk, se))
    return imgs, masks, raw_masks


def match_pair(
    cfg: ReconstructionConfig,
    image0: np.ndarray,
    image1: np.ndarray,
    mask0: np.ndarray,
    mask1: np.ndarray,
    K0: np.ndarray,
    Rt0: np.ndarray,
    K1: np.ndarray,
    Rt1: np.ndarray,
    *,
    device="cuda",
) -> PairResult:
    """Full per-pair pipeline (`MatchAllLayer`, `CStereoMatching.cpp:17-32`):
    rectify + remap at working resolution, mask erosion, pyramids,
    per-level matching, triangulation.

    Images and masks are original-resolution host arrays (BGR / [0,255]);
    ``device`` is where the work runs: the card unless the caller asks
    for "cpu" (the plain versions of the kernels)."""
    device = torch.device(device)
    origin_size = (image0.shape[1], image0.shape[0])
    working = cfg.finest_size
    rect = rectify_pair(K0, Rt0, K1, Rt1, origin_size, working)
    imgs, masks, raw_masks = remap_pair_views(
        cfg, image0, image1, mask0, mask1, K0, K1, rect, working, device)

    L = cfg.pyramid_levels
    pyr0 = build_pyramid(imgs[0], L)
    pyr1 = build_pyramid(imgs[1], L)
    mpyr0 = [quantize_u8(m) for m in build_pyramid(masks[0], L)]
    mpyr1 = [quantize_u8(m) for m in build_pyramid(masks[1], L)]

    timed = device.type == "cuda"
    events = [torch.cuda.Event(enable_timing=True) for _ in range(L + 1)] \
        if timed else []
    if timed:
        events[0].record()
    state: Optional[LevelState] = None
    drifts = []
    for level in range(L):
        state = match_one_level(
            quantize_u8(pyr0[level]), quantize_u8(pyr1[level]),
            mpyr0[level], mpyr1[level], state, level,
            radius=cfg.stereo.block_radius,
            offset=cfg.stereo.disparity_offset,
            ws=cfg.stereo.refine_ws,
            refine_iters=cfg.refine_iterations(level),
            median_iters=cfg.stereo.median_iterations,
            recenter_every=cfg.stereo.refine_recenter_every,
        )
        drifts.append(torch.stack([state.refine_drift0, state.refine_drift1]))
        if timed:
            events[level + 1].record()

    finest = L - 1
    radius = cfg.stereo.block_radius
    m0 = find_margin(valid_mask(mpyr0[finest]), radius)
    m1 = find_margin(valid_mask(mpyr1[finest]), radius)
    scale = cfg.lowest_level_size[0] / origin_size[0] * (1 << finest)
    cloud = disparity_to_cloud(
        state.disp0, mpyr0[finest], quantize_u8(pyr0[finest]),
        rect.Q, rect.R_final, rect.T_final, m0, scale,
        erode_frac=cfg.stereo.cloud_erode_frac)

    u8 = torch.uint8
    level_ms = None
    if timed:
        events[-1].synchronize()
        level_ms = [events[i].elapsed_time(events[i + 1]) for i in range(L)]
    return PairResult(
        disparity=state.disp0,
        cloud=cloud,
        rectification=rect,
        margins0=m0,
        margins1=m1,
        rect_images=(imgs[0].to(u8), imgs[1].to(u8)),
        rect_masks=(quantize_u8(raw_masks[0]).to(u8),
                    quantize_u8(raw_masks[1]).to(u8)),
        refine_drift=torch.stack(drifts),
        rect_masks_eroded=(masks[0].to(u8), masks[1].to(u8)),
        level_ms=level_ms,
    )
