"""Configuration of the port (counterpart of `reconstruction_tpu/config.py`).

The same field names, defaults and presets as the reference's, for the
parts the port runs: the run keys, the pyramid keys, the pair table,
`StereoParams`, `CloudParams` and `SurfaceParams`.  The bundle-adjustment
and layout parameters come with the stages that read them; the
reference's `dispatch_depth` (its bound on pairs in flight) has no
counterpart, since the port runs the pairs one after the other.  The port
imports nothing of the JAX package, so it stands alone on a machine that
has no JAX.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# Sentinel for "no match" disparities (`reconstruction/CStereoMatching.h:9`).
NOMATCH = -10000


@dataclass(frozen=True)
class StereoParams:
    """Dense-stereo stage parameters (`CReconstruction.cpp:17`,
    `CStereoMatching.cpp`)."""

    # NCC matching window radius.
    block_radius: int = 2
    # Smoothing weight ws in the subpixel refine.
    refine_ws: float = 0.03
    # Guided-search half width around the upsampled coarse disparity.
    disparity_offset: int = 2
    # Per-step decay for disparity-bound propagation (MAX_DISPARITY).
    max_disparity_step: int = 2
    # Refinement sweeps per level: base + slope * level (30 + 30*level).
    refine_iters_base: int = 30
    refine_iters_per_level: int = 30
    # Smoothness-constraint violation threshold |d - d_neighbor| > 1.
    smooth_violation_threshold: int = 1
    # Median-filter iterations.
    median_iterations: int = 1
    # Mask-erosion ellipse diameter at full resolution, in units of
    # 3 * 2^(PyrmNum-1) pixels.
    mask_erode_base: int = 3
    # Extra erosion before triangulation, fraction of image height.
    cloud_erode_frac: float = 0.02
    # The program's refine options, carried by each configuration file;
    # the reference reads none of them: its refine is float32 throughout.
    refine_impl: str = "auto"
    refine_cv_dtype: str = "float32"
    refine_extract: str = "chain"
    # Window re-centering cadence: -1 = auto (one mid-run re-extraction),
    # 0 = off, k > 0 = every k sweeps.
    refine_recenter_every: int = -1


@dataclass(frozen=True)
class CloudParams:
    """Point-cloud optimization parameters (`CReconstruction.cpp:18`,
    `CCloudOptimization.cpp:40-56`)."""

    # Statistical outlier removal: k nearest neighbors and std multiplier.
    sor_mean_k: int = 100
    sor_std_thresh: float = 1.0
    # Radius outlier removal (commented out in the reference,
    # `CCloudOptimization.cpp:90-96`; an optional stage).
    outrem_neighbors: int = 50
    outrem_radius: float = 2.0
    use_radius_outlier_removal: bool = False
    # Normal-estimation / MLS search radius (`CCloudOptimization.cpp:106,358`);
    # the MLS fit is order 1 (a plane), as the reference hard-codes.
    mls_radius: float = 2.5
    # Cross-view dedup enabled (`isdelete`, `CReconstruction.cpp:18` false).
    dedup: bool = False
    # Cloud-stage backend: "torch" (voxel-grid reduces on the pair's
    # device), "native" (C++/OpenMP exact k-NN on the host) or "auto",
    # which is "torch" (cloud/backend.py).
    backend: str = "auto"
    # Read by the reference's fixed-capacity buffers; kept for equal presets.
    max_points_per_pair: int = 1 << 21
    max_neighbors: int = 128


@dataclass(frozen=True)
class SurfaceParams:
    """Surfacing parameters: the dense-grid Poisson solve, the trim and the
    mesh cleanup that replace the reference's external tools
    (`Demo/mesh.bat:1-3`, `Demo/meshlab.bat:1-2`)."""

    # Per-pair and global Poisson octree depths of the external tools
    # (`Demo/mesh.bat:1`, `Demo/meshlab/script1.mlx`); not read by the
    # dense solver.
    pair_depth: int = 9
    global_depth: int = 10
    # Dense-grid resolution of the Poisson solve.
    grid_resolution: int = 256
    # Screened-Poisson point weight (`Demo/mesh.bat:1`, --pointWeight 0).
    point_weight: float = 0.0
    # Splat support radius in voxels (not read: the splat is trilinear).
    splat_radius: float = 1.5
    # Fixed-point iterations of the screened solve; the smoothing counts
    # belong to the reference's multigrid V-cycle.
    mg_cycles: int = 8
    mg_pre_smooth: int = 2
    mg_post_smooth: int = 2
    # Density trim quantile (SurfaceTrimmer --trim 7, as a density quantile).
    trim_quantile: float = 0.05
    # Island removal threshold (`script2.mlx` MinComponentDiag, fraction of
    # the bounding-box diagonal).
    min_component_diag_frac: float = 0.10
    # Laplacian smoothing steps (`script1.mlx`, stepSmoothNum 5).
    laplacian_steps: int = 5
    laplacian_cotangent: bool = True
    # Close holes up to this boundary-edge count (`script2.mlx`, 30).
    close_holes_max_edges: int = 30
    # Trim smoothing iterations (SurfaceTrimmer --smooth 100).
    trim_smooth_iters: int = 100
    # Per-pair Poisson grid; 0 = grid_resolution.
    pair_grid_resolution: int = 0


@dataclass(frozen=True)
class ReconstructionConfig:
    """Top-level run configuration; field names mirror the reference's
    YAML keys (`reconstruction/CManageData.cpp:26-43`)."""

    filepath: str = ""
    outfilename: str = "out.ply"
    isoutput: bool = False
    camera_calib_name: str = "calib_camera.yml"
    # Pyramid levels (`PyrmNum`).
    pyramid_levels: int = 4
    # Coarsest-level size (`LowestLevelWidth/Height`): (width, height).
    lowest_level_size: Tuple[int, int] = (160, 240)
    # Per-camera relative image/mask paths, indexed by camID.
    imagelist: Tuple[str, ...] = ()
    masklist: Tuple[str, ...] = ()
    # Stereo pair table: rows of (left camID, right camID)
    # (`BatchProcess/main.cpp:30-35`).
    cam_pairs: Tuple[Tuple[int, int], ...] = ((0, 1), (2, 3), (4, 5), (7, 6))
    stereo: StereoParams = field(default_factory=StereoParams)
    cloud: CloudParams = field(default_factory=CloudParams)
    surface: SurfaceParams = field(default_factory=SurfaceParams)

    @property
    def num_pairs(self) -> int:
        return len(self.cam_pairs)

    @property
    def finest_size(self) -> Tuple[int, int]:
        """(width, height) of the finest pyramid level, the rectified
        working resolution."""
        return self.level_size(self.pyramid_levels - 1)

    def level_size(self, level: int) -> Tuple[int, int]:
        """(width, height) at pyramid ``level`` (0 = coarsest)."""
        s = 1 << level
        return (self.lowest_level_size[0] * s, self.lowest_level_size[1] * s)

    def refine_iterations(self, level: int) -> int:
        """`CStereoMatching.cpp:95`: 30 + 30*level."""
        return self.stereo.refine_iters_base + self.stereo.refine_iters_per_level * level

    def replace(self, **kw) -> "ReconstructionConfig":
        return dataclasses.replace(self, **kw)


def preset(name: str) -> ReconstructionConfig:
    """The reference's named presets: "myself" (the face-rig wiring), "ETH"
    (its commented variant: SOR 100/0.5, outrem 50/2, mls_radius 0.5),
    "tiny" (the small synthetic preset of the tests; cloud radii in the
    synthetic scene's world units) and "dome32"."""
    if name == "myself":
        return ReconstructionConfig()
    if name == "ETH":
        return ReconstructionConfig(
            cloud=CloudParams(sor_mean_k=100, sor_std_thresh=0.5,
                              outrem_neighbors=50, outrem_radius=2.0,
                              mls_radius=0.5))
    if name == "tiny":
        return ReconstructionConfig(
            pyramid_levels=2,
            lowest_level_size=(64, 48),
            cam_pairs=((0, 1),),
            cloud=CloudParams(sor_mean_k=30, mls_radius=0.08,
                              max_points_per_pair=1 << 14),
            surface=SurfaceParams(grid_resolution=64, mg_cycles=4))
    if name == "dome32":
        return ReconstructionConfig(
            pyramid_levels=5,
            lowest_level_size=(240, 135),
            cam_pairs=tuple((2 * i, 2 * i + 1) for i in range(16)))
    raise KeyError(
        f"unknown preset {name!r}; available: myself, ETH, tiny, dome32")
