"""Configuration tree of the PyTorch port.

A copy of the JAX package's ``config.py`` with the same field names and
defaults, so a configuration reads the same in both packages. The port
keeps its own copy because it imports nothing of the JAX package.

Values the port does not implement yet raise ``NotImplementedError`` at
construction, naming the ROADMAP.md item that will add them; "auto"
resolves to what the port has (``ops.resolve_backend``): the CUDA kernel
for CUDA tensors, the plain PyTorch form for CPU tensors.

The original module docstring follows.

Configuration tree for the TPU moving-object-detection pipeline.

Mirrors the reference's three-tier config system (SURVEY.md §5): the
dynamic_reconfigure ``.cfg`` defaults become plain dataclass defaults here
(reference: scene_flow_constructor/cfg/SceneFlowConstructor.cfg:8-9,
scene_flow_clusterer/cfg/Clusterer.cfg:8-11,
moving_object_tracker/cfg/MovingObjectTracker.cfg:8-10).

Hot-tunable scalars (thresholds) are carried *inside* jitted functions as
traced array arguments so retuning never triggers recompilation; structural
knobs (capacities, window sizes, resolutions) are static and hashable so they
participate in the jit cache key.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SceneFlowConfig:
    """Scene-flow construction knobs.

    ``dynamic_flow_diff``: pixel distance between the measured optical flow and
    the ego-motion-induced ("static") flow above which a pixel is labelled
    dynamic (reference SceneFlowConstructor.cfg:8, default 5 px).
    """

    dynamic_flow_diff: float = 5.0
    # Disparity-rate dynamic test (px/s; 0 = off = reference parity). The
    # 2D flow gate above is blind to objects approaching along the
    # optical axis: their image expansion barely crosses any pixel gate
    # (measured 2026-08-21: a 3 m/s object at 9-11 m produces ~1.9 px of
    # rim expansion vs the ~1.8 px effective gate — 0 detections in the
    # approach validation scene even with GT flow; the reference has the
    # same blind spot, scene_flow_constructor.cpp:196-198). The disparity
    # change between the measured current disparity and the ego-motion-
    # predicted one measures that motion directly at EVERY object pixel,
    # so when > 0 a pixel is also dynamic if |d_now - d_predicted|/dt >=
    # dynamic_disparity_rate. Disparity units make the gate's noise floor
    # DEPTH-UNIFORM (SGM subpixel jitter is ~constant px at any depth);
    # an absolute m/s z-velocity gate was measured to phantom on far
    # background, where vz noise scales as z^2 (1.5 m/s at z=12 is only
    # ~1.5 px/s of disparity noise, scene matrix 2026-08-21). Validated
    # operating point: 3.0 px/s (approach scene detected at 192x448
    # fx=300 where the object sweeps 3.7-5.6 px/s, background noise tail
    # ~1.5 px/s; margins double at KITTI fx/baseline). Hot-tunable
    # (Tunables.dynamic_disparity_rate).
    dynamic_disparity_rate: float = 0.0
    max_color_velocity: float = 1.0  # visualization-only (cfg:9)
    # Backend for the flow-matched previous-disparity lookup (the hot
    # 467k-index gather): "pallas" = the windowed CUDA kernel
    # (ops/gather_cuda.py; the name is the reference package's word for
    # the kernel form), "xla" = plain gather (unbounded match distance),
    # "fused" = the ENTIRE scene-flow construct as one CUDA kernel
    # (ops/sceneflow_cuda.py; window semantics as "pallas"), "auto" =
    # "pallas" for CUDA tensors and "xla" for CPU tensors. With the
    # windowed backends, matches outside the covered window of the radii
    # below are treated as invalid (no velocity at that pixel), the same
    # degradation the reference applies to out-of-image matches. A kernel
    # wrapper given CPU tensors runs its plain version, so every value
    # works on the CPU too. The reference package's "pallas_interpret" /
    # "fused_interpret" (its kernels in interpreter mode) have no meaning
    # here and raise ValueError.
    gather_backend: str = "auto"
    match_v_radius: int = 16  # max |vertical flow| px matched by the kernel
    match_h_radius: int = 128  # max |horizontal flow| px matched

    def __post_init__(self):
        if self.gather_backend not in ("auto", "xla", "pallas", "fused"):
            raise ValueError(f"unknown gather_backend {self.gather_backend!r}")


@dataclasses.dataclass(frozen=True)
class ClustererConfig:
    """Detection-stage knobs (reference Clusterer.cfg:8-11).

    ``max_objects`` is new: the jit-friendly fixed capacity replacing the
    reference's unbounded cluster vector.
    """

    cluster_size: int = 2500
    depth_diff: float = 0.15
    dynamic_speed: float = 0.3
    # Compile-time MAXIMUM window radius (stencil shape). The effective
    # radius is the Tunables.neighbor_distance traced scalar (defaults to
    # this value): any runtime retune in [0, this] applies without a
    # recompile (Clusterer.cfg:11 is hot-tunable like the other knobs);
    # raising the maximum itself recompiles.
    neighbor_distance: int = 4
    max_objects: int = 16
    # Upper bound on label-propagation sweeps for connected components.
    max_cc_iters: int = 64
    # The reference package's Pallas CC kernel caps its per-iteration
    # scan reach at this many pixels (0 = full image span). The port's CUDA
    # connected components are a union-find with no scans, so the field is
    # kept for configuration parity and read by nothing.
    cc_scan_span: int = 128
    # Connected-components and cluster-stats backend: "pallas" = the CUDA
    # kernels (ops/clustering_cuda.py, ops/cluster_stats_cuda.py; the name
    # is the reference package's word for the kernel form), "xla" = the
    # plain scan/sweep fixpoint and masked passes, "auto" = "pallas" for
    # CUDA tensors and "xla" for CPU tensors. "pallas_interpret" has no
    # meaning here and raises ValueError.
    cc_backend: str = "auto"
    # Dynamic-extent crop fast path (0 = off): when every dynamic pixel
    # fits in a (cc_crop_h, cc_crop_w) window, the WHOLE busy clustering
    # stage (CC fixpoint, lexicographic sort, stats) runs on that window
    # instead of the full frame. Exact by construction: window edges need
    # both endpoints dynamic, so clustering restricted to any window
    # containing all dynamic pixels yields the identical partition, and
    # raster order (hence root choice and cluster ordering) is preserved
    # under cropping. Frames whose dynamic extent exceeds the window take
    # the full-frame path via lax.cond. This scales busy-frame cost with
    # CONTENT extent, like the reference's per-cluster loops
    # (clusterer_nodelet.cpp:56-83) whose work scales with dynamic-pixel
    # count. The default 192x512 favors fallback robustness (close/tall
    # objects) over a smaller, faster window (the reference package chose
    # it from its TPU benchmarks, BENCH_MATRIX round 3); the fast path
    # auto-disables when the window would not shrink the frame (e.g. the
    # 192x448 validation scenes).
    cc_crop_h: int = 192
    cc_crop_w: int = 512
    # Max crop windows when the dynamic extent defeats a single
    # (cc_crop_h, cc_crop_w) window: 2 = try a two-window split at the
    # widest all-static column gap (exact when the gap exceeds the
    # neighbor radius — no CC edge can cross it; clusterer._busy_branch),
    # falling back to the full-frame path when no such split exists.
    # 1 = single-window behavior only.
    cc_crop_windows: int = 2

    def __post_init__(self):
        if self.cc_backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown cc_backend {self.cc_backend!r}")


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Tracking knobs (reference MovingObjectTracker.cfg:8-10 plus the
    hard-coded gates in moving_objects_tracker.cpp:27 and noise constants in
    kalman_tracker.hpp:42-51)."""

    covariance_trace_limit: float = 0.5
    correction_count_limit: int = 3
    object_radius: float = 0.5
    # Gates hard-coded in the reference's distance<> specialization
    # (moving_objects_tracker.cpp:27): sqrt(mahalanobis) > 3, euclid > 1.5.
    gating_mahalanobis: float = 3.0
    gating_deviation: float = 1.5
    # Noise constants (kalman_tracker.hpp:42-51).
    process_noise_pos: float = 0.003
    process_noise_vel: float = 0.01
    measurement_noise: float = 0.2
    initial_cov: float = 0.1
    min_dt: float = 0.001
    max_tracks: int = 64
    # Association mode: "nn" = greedy nearest neighbor (the reference's
    # wired-in default, nearest_neighbor_association.hpp); "gnn" = global
    # nearest neighbor via optimal assignment (the reference's available-but
    # -unwired Munkres mode, global_nearest_neighbor_association.hpp, here
    # an auction solver).
    association: str = "nn"

    def __post_init__(self):
        if self.association not in ("nn", "gnn"):
            raise ValueError(f"unknown association {self.association!r}")


@dataclasses.dataclass(frozen=True)
class SGMConfig:
    """Pallas/XLA semi-global-matching stereo knobs (replaces sgm_gpu_ros,
    SURVEY.md §2.3)."""

    max_disparity: int = 128
    p1: int = 10
    p2: int = 120
    # Census window (height, width), both odd. Windows beyond 32 census
    # bits (e.g. 7x7 = 48 bits) are not supported: the transform packs
    # into int32 and the Pallas v2 kernels assume the <=24-bit/5x5 cost
    # ceiling (ops/sgm_pallas2.py). sgm_disparity_raw raises on oversize
    # windows rather than silently clamping.
    census_window: Tuple[int, int] = (5, 5)
    # 4 = horizontal fwd/bwd + vertical fwd/bwd (Pallas v2 serving
    # kernels); 8 adds the diagonals (XLA backend only). The 4-path
    # default is MEASURED, not just faster: on the real-texture planar
    # scenes (io/scenes.py, 2026-08-20) 8-path scored WORSE — D1 1.81%
    # vs 1.32%, |err| 0.457 vs 0.397 px at equal density — because
    # diagonal aggregation smears depth edges of fronto-parallel
    # structure without adding support the h/v paths lack.
    num_paths: int = 4
    lr_check: bool = True
    lr_max_diff: float = 1.0
    subpixel: bool = True
    # Uniqueness test (libSGM/OpenCV-SGBM lineage): invalidate a pixel
    # whose best total does not beat every non-adjacent disparity's total
    # by the factor 1/ratio (min_{|d-best|>1} total(d) * ratio >= best).
    # Implemented in the XLA and Pallas v2 WTA (ops/sgm.py,
    # ops/sgm_pallas2.py, bitwise-matching). Default 0 = DISABLED: the
    # sgm_gpu CUDA kernel the reference consumed (sgm_gpu_ros, SURVEY.md
    # §2.3) applies no uniqueness filter — its post-processing is the LR
    # check only — and every quality gate in this repo was validated with
    # it off. 0.95 reproduces the libSGM default when wanted.
    uniqueness_ratio: float = 0.0
    # SGM backend: "pallas" = the census-input v2 CUDA kernels
    # (ops/sgm_cuda.py; the name is the reference package's word for the
    # kernel form), "pallas_v1" = the stored-volume v1 CUDA kernels
    # (ops/sgm_v1_cuda.py: census, Hamming cost, aggregation over the
    # stored int8 volume, WTA without uniqueness), "xla" = the plain form
    # (the only one with 8 paths or D != 128), "auto" = "pallas" for CUDA
    # tensors and "xla" for CPU tensors. The reference package's
    # "*_interpret" names (its kernels in interpreter mode) have no
    # meaning here and raise ValueError.
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in ("auto", "pallas", "pallas_v1", "xla"):
            raise ValueError(f"unknown SGM backend {self.backend!r}")
        if self.p1 < 0:  # the vertical DP kernel adds 16-bit costs >= 0
            raise ValueError(f"P1={self.p1}: path costs need P1 >= 0")


@dataclasses.dataclass(frozen=True)
class EgoMotionConfig:
    """Stereo visual odometry knobs (replaces libviso2, SURVEY.md §2.3).

    Batched corner detection + pyramidal LK tracking + vmapped RANSAC +
    Gauss-Newton pose refinement, all with static shapes.
    """

    max_features: int = 512
    nms_radius: int = 7
    lk_pyramid_levels: int = 3
    lk_window: int = 7  # half-size of the LK patch
    lk_iters: int = 8
    ransac_hypotheses: int = 64
    ransac_sample: int = 3
    gn_iters_hypothesis: int = 5
    gn_iters_refine: int = 8
    # Top-K RANSAC hypotheses that get the full two-pass refinement; the
    # winner is chosen by FINAL inlier count. Guards against the planar
    # yaw/lateral-translation trade-off locking a central-feature subset
    # (see _ransac_gn_solve); 1 reproduces the old single-candidate path.
    refine_candidates: int = 4
    inlier_threshold_px: float = 2.0
    min_inliers: int = 12
    bucket_h: int = 4  # feature bucketing grid (viso2-style, odometry_params.h)
    bucket_w: int = 8
    # In the fused pipeline, take feature correspondences from the dense PWC
    # flow (cheap gathers) instead of running per-feature LK (slow scattered
    # gathers on TPU). Standalone estimate_motion still supports LK.
    use_dense_flow: bool = True
    # Redundancy policy for dense-flow mode: when the dense-correspondence
    # RANSAC keeps fewer than lk_fallback_frac of the valid features as
    # inliers (a corrupted/hallucinated flow field), re-derive the motion
    # from independent pyramidal-LK tracks — the role of the reference's
    # separate libviso2 matcher (scene_flow_constructor.cpp:230), which
    # never shared a failure mode with the PWC flow. lax.cond keeps the LK
    # path off the hot profile when the flow is healthy (note: under vmap
    # — parallel/streams.py — both branches execute).
    lk_fallback: bool = True
    lk_fallback_frac: float = 0.5


@dataclasses.dataclass(frozen=True)
class FlowNetConfig:
    """PWC-Net-style optical-flow network (replaces pwc_net_ros + Caffe,
    SURVEY.md §2.3)."""

    pyramid_levels: int = 6
    search_range: int = 4  # correlation max displacement
    # Input channels the weights expect (1 = grayscale, 3 = RGB). Like the
    # other architecture fields, inferred from checkpoint kernel shapes at
    # load (models.pwc_net.infer_flow_config); the pipeline adapts frames
    # to this count (pipeline._adapt_flow_channels).
    in_channels: int = 1
    feature_channels: Tuple[int, ...] = (16, 32, 64, 96, 128, 196)
    # Decoder widths. Defaults match the original PWC-Net heads; slim
    # variants (a retraining experiment, PLAN_NEXT item 2) shrink these.
    # Changing either invalidates checkpoints.
    estimator_channels: Tuple[int, ...] = (128, 128, 96, 64, 32)
    context_channels: Tuple[int, ...] = (128, 128, 128, 96, 64, 32)
    use_context_net: bool = True
    # Occlusion cue (VERDICT r4 #4): append the mean |f1 - warp(f2)|
    # residual as one extra estimator-input channel per level. High
    # exactly where the warped match is hidden behind an occluding edge
    # — the measured failure mode of loss-only training (paste-probe
    # residual concentrated on the OCCLUDING half). Off by default;
    # inferred from checkpoint shapes at load, and an existing checkpoint
    # can be upgraded exactly (zero-init new kernel rows,
    # scripts/augment_flow_occlusion.py) before finetuning.
    occlusion_cue: bool = False
    dtype: str = "bfloat16"
    # Correlation-layer backend: "pallas" = fused VMEM kernel
    # (ops/flow_corr_pallas.py), "xla" = shift-and-reduce, "auto" = pallas
    # on accelerators. Default is "auto": the kernel is hardware-validated
    # against the XLA oracle (max rel err ~4e-7 across pyramid shapes) and
    # saves 5.2 ms/frame INSIDE the fused pipeline at KITTI res (24.0 ->
    # 18.9 ms) — the XLA form lowers to 81 multiply-reduce tuples + an
    # 81-slice concatenate in-context (scripts/profile_trace.py) even
    # though it looks free standalone (scripts/profile_corr_incontext.py).
    corr_backend: str = "auto"
    # Warp-layer backend: "gather" = exact bilinear (default); "two_pass" =
    # gather-free approximate fast path (ops/flow_ops.py warp_two_pass) —
    # train and serve with the same setting.
    warp_backend: str = "gather"
    # ContextNetwork dilated-conv lowering: "direct" = XLA's native
    # kernel dilation; "space_to_batch" = mathematically identical
    # decomposition into d*d dense convs on phase-subsampled grids (same
    # params, checkpoint-compatible either way). Default space_to_batch:
    # 0.61 vs 7.96 ms standalone at the finest KITTI level on v5e — XLA
    # lowers large kernel dilations very poorly on TPU.
    context_dilation_impl: str = "space_to_batch"

    def __post_init__(self):
        if self.corr_backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown corr_backend {self.corr_backend!r}")
        if self.warp_backend not in ("gather", "two_pass"):
            raise ValueError(f"unknown warp_backend {self.warp_backend!r}")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level static configuration. Hashable: safe as a jit static arg."""

    height: int = 376
    width: int = 1242
    # Color input path. False: (H, W) grayscale frames end-to-end. True:
    # frames arrive as (H, W, 3) RGB; the flow net sees whatever channel
    # count its weights were trained with (FlowNetConfig.in_channels —
    # luma-collapsed for 1-channel weights), while SGM and ego-motion
    # always run on luma, matching the reference: the camera's native
    # image goes to PWC-Net (scene_flow_constructor.cpp:279-282) and only
    # viso2 gets MONO8 (:220-221).
    color: bool = False
    # Run the flow net at 1/N resolution (upscaled back): serving speed
    # knob for e.g. the ZED-live operating point.
    flow_input_scale: int = 1
    # Run SGM stereo at 1/N resolution: the matcher sees downsampled
    # images; valid disparities are nearest-upsampled and scaled by N
    # (invalid -1 pixels stay exactly -1 — bilinear would smear them into
    # neighbors). ~N^2 cheaper DP aggregation, the stereo analog of the
    # reference's crop-to-run-fast operating point
    # (detect_with_zed.launch:10-14). No learned weights involved, but
    # depth quantization coarsens by N: gate with
    # scripts/validate_detection_quality.py before serving.
    sgm_input_scale: int = 1
    scene_flow: SceneFlowConfig = dataclasses.field(default_factory=SceneFlowConfig)
    clusterer: ClustererConfig = dataclasses.field(default_factory=ClustererConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    sgm: SGMConfig = dataclasses.field(default_factory=SGMConfig)
    egomotion: EgoMotionConfig = dataclasses.field(default_factory=EgoMotionConfig)
    flownet: FlowNetConfig = dataclasses.field(default_factory=FlowNetConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = PipelineConfig()
