"""Per-level and per-pair stereo drivers (counterpart of
`reconstruction_tpu/stereo/pipeline.py`).

Per level and direction, in the reference's stage order
(`CStereoMatching.cpp:36-113`):

  brute (level 0) or guided match -> smoothness -> ordering -> uniqueness
  -> bound propagation + rematch -> uniqueness -> median -> refine
  (30 + 30*level sweeps) -> uniqueness

and per pair (`MatchAllLayer`): rectify -> remap -> mask erosion ->
pyramids -> levels coarse to fine -> triangulation.  Everything image
sized runs on the ``device`` given to `match_pair`; the sweeps, the cost
volume and the refine run as kernels K1, K3 and K2 on a CUDA device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from reconstruction_tpu_torch.config import NOMATCH, ReconstructionConfig
from reconstruction_tpu_torch.core.morphology import erode_mask, valid_mask
from reconstruction_tpu_torch.core.pyramid import quantize_u8
from reconstruction_tpu_torch.core.rectify import RectifyResult, rectify_pair
from reconstruction_tpu_torch.core.remap import rectify_inverse, remap_bilinear
from reconstruction_tpu_torch.ops.pyramid import build_pyramid
from reconstruction_tpu_torch.ops.rectify_map import rectify_map
from reconstruction_tpu_torch.stereo.constraints import (
    median_filter, ordering_constraint, propagate_bounds,
    smoothness_constraint, uniqueness_constraint)
from reconstruction_tpu_torch.stereo.margins import Margins, find_margin
from reconstruction_tpu_torch.stereo.matching import (
    brute_force_match, guided_match, rematch)
from reconstruction_tpu_torch.stereo.refine import disparity_refine, resolve_recenter
from reconstruction_tpu_torch.stereo.triangulate import (
    PointCloud, disparity_to_cloud)
from reconstruction_tpu_torch.utils.timing import span


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


# T of the reference's Pallas refine when it streams a bfloat16 window
# (`reconstruction_tpu/stereo/pipeline.py:159`).
_PALLAS_T = 6


def refine_volume_dtype(refine_impl: str, refine_cv_dtype: str,
                        iterations: int, recenter_every: int) -> str:
    """The cost volume's dtype of one level's refine, where the reference's
    pair path uses a bfloat16 window: ``refine_cv_dtype`` "bfloat16" with
    its Pallas refine, which the port's "auto" stands for on every device
    (its plain versions stand for its kernels), and only where that refine
    does not fall back to the float32 XLA path (``iterations`` or a
    positive re-extraction cadence off a multiple of T,
    `reconstruction_tpu/ops/refine_pallas.py:191-193`)."""
    if refine_cv_dtype != "bfloat16" or refine_impl not in ("auto", "pallas"):
        return "float32"
    every = resolve_recenter(iterations, recenter_every, _PALLAS_T)
    if iterations % _PALLAS_T or (every > 0 and every % _PALLAS_T):
        return "float32"
    return "bfloat16"


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
    refine_impl: str = "auto",
    recenter_every: int = -1,
    refine_cv_dtype: str = "float32",
    refine_extract: str = "chain",
) -> LevelState:
    """One pyramid level for both directions (`MatchOneLayer`,
    `CStereoMatching.cpp:36-113`).  The directions run one after the
    other, like the reference's back-to-back calls; the uniqueness passes
    couple them.

    ``refine_cv_dtype="bfloat16"`` stores the refine's cost volume in
    bfloat16 where the reference's Pallas refine streams a bfloat16 window
    (`refine_volume_dtype`); ``refine_impl`` only gates that, since the
    reference's float32 code paths give the same result.
    ``refine_extract`` ("chain" or "tree", equal) is accepted and
    ignored."""
    del refine_extract
    cv_dtype = refine_volume_dtype(refine_impl, refine_cv_dtype, refine_iters,
                                   recenter_every)
    v0, v1 = valid_mask(mask0), valid_mask(mask1)
    m0, m1 = find_margin(v0, radius), find_margin(v1, radius)
    lanes = ((img0, img1, v0, v1, m0, m1), (img1, img0, v1, v0, m1, m0))

    ds = []
    for lane, (ai, bi, av, bv, am, bm) in enumerate(lanes):
        with span("match"):
            if level == 0:
                d = brute_force_match(ai, bi, av, bv, am, bm, radius)
            else:
                assert coarse is not None
                ac = coarse.disp0 if lane == 0 else coarse.disp1
                d = guided_match(ai, bi, av, bv, ac, am, bm, radius, offset)
        with span("constraints"):
            d = smoothness_constraint(d, am)
            ds.append(ordering_constraint(d, am))
    with span("constraints"):
        d0, d1 = uniqueness_constraint(ds[0], ds[1], m0, m1)

    ds = []
    for (ai, bi, av, bv, am, bm), d in zip(lanes, (d0, d1)):
        with span("constraints"):
            bl, br = propagate_bounds(d, av, am, bm)
        with span("rematch"):
            ds.append(rematch(ai, bi, av, bv, d, bl, br, am, radius))
    with span("constraints"):
        d0, d1 = uniqueness_constraint(ds[0], ds[1], m0, m1)

    ds, drifts = [], []
    for (ai, bi, av, bv, am, bm), d in zip(lanes, (d0, d1)):
        with span("median"):
            d = median_filter(d, av, am, median_iters)
        with span("refine"):
            out = disparity_refine(d, ai, bi, am, refine_iters, ws, s_cap,
                                   recenter_every=recenter_every, cv_dtype=cv_dtype)
            ds.append(out)
            drifts.append(_drift(d, out))
    with span("constraints"):
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
    (`CStereoMatching.cpp:140-158`), their maps built there (K8 on a CUDA
    device, `ops/rectify_map`).  Returns (images on the uint8 grid,
    eroded masks, pre-erosion masks), float32 tensors."""
    se = cfg.stereo.mask_erode_base * (1 << (cfg.pyramid_levels - 1))
    imgs, masks, raw_masks = [], [], []
    for img, msk, K, Rr, P in ((image0, mask0, K0, rect.R1, rect.P1_scaled),
                               (image1, mask1, K1, rect.R2, rect.P2_scaled)):
        with span("rectify_map"):
            mx, my = rectify_map(rectify_inverse(Rr, P), K, working, device)
        with span("upload"):
            img_d = torch.from_numpy(np.asarray(img, np.float32)).to(device)
            msk_d = torch.from_numpy(np.asarray(msk, np.float32)).to(device)
        with span("remap"):
            im = remap_bilinear(img_d, mx, my)
            mk = remap_bilinear(msk_d, mx, my)
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
    with span("match_pair"):
        origin_size = (image0.shape[1], image0.shape[0])
        working = cfg.finest_size
        with span("rectify"):
            rect = rectify_pair(K0, Rt0, K1, Rt1, origin_size, working)
        imgs, masks, raw_masks = remap_pair_views(
            cfg, image0, image1, mask0, mask1, K0, K1, rect, working, device)

        L = cfg.pyramid_levels
        with span("pyramid"):
            pyr0 = build_pyramid(imgs[0], L)
            pyr1 = build_pyramid(imgs[1], L)
            mpyr0 = build_pyramid(masks[0], L, quantize=True)
            mpyr1 = build_pyramid(masks[1], L, quantize=True)

        timed = device.type == "cuda"
        with span("levels"):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(L + 1)] \
                if timed else []
            if timed:
                events[0].record()
            state: Optional[LevelState] = None
            drifts = []
            for level in range(L):
                with span(f"level{level}"):
                    state = match_one_level(
                        quantize_u8(pyr0[level]), quantize_u8(pyr1[level]),
                        mpyr0[level], mpyr1[level], state, level,
                        radius=cfg.stereo.block_radius,
                        offset=cfg.stereo.disparity_offset,
                        ws=cfg.stereo.refine_ws,
                        refine_iters=cfg.refine_iterations(level),
                        median_iters=cfg.stereo.median_iterations,
                        refine_impl=cfg.stereo.refine_impl,
                        recenter_every=cfg.stereo.refine_recenter_every,
                        refine_cv_dtype=cfg.stereo.refine_cv_dtype,
                        refine_extract=cfg.stereo.refine_extract,
                    )
                    drifts.append(torch.stack([state.refine_drift0, state.refine_drift1]))
                    if timed:
                        events[level + 1].record()

        # The level events' read is the first wait for the levels' device
        # work, so this span holds that wait.
        with span("triangulate"):
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
