"""Static configuration of the SLAM engine.

Counterpart of the JAX package's models/config.py (reference settings file
+ constants, src/Tracking.cc:93-218): the same names and defaults; a
configuration built for the JAX package builds here too.
"""

from __future__ import annotations

from typing import NamedTuple

from ..ops.camera import CameraParams
from ..ops.orb.extractor import OrbConfig


class Capacities(NamedTuple):
    """Fixed array capacities of the map and the per-frame working sets."""

    max_keyframes: int = 256
    max_points: int = 65536
    local_points: int = 2048   # frustum-visible local map points per frame
    local_keyframes: int = 80  # reference caps the local-KF set at 80 (Tracking.cc:1964)
    # Local bundle adjustment window: the top covisible keyframes free, the
    # top second-ring observers fixed, the window's points (Optimizer.cc:
    # 640-724, capacity-bounded by covisibility ranking)
    ba_free_kfs: int = 12
    ba_fixed_kfs: int = 12
    ba_points: int = 4096
    # Gauss-Newton budget of the local BA before / after the outlier gate
    # (the reference runs 5 + 10, Optimizer.cc:863-917)
    ba_iters_pre: int = 3
    ba_iters_post: int = 5
    cull_log: int = 2048       # retired-keyframe archive ring
    loop_log: int = 32         # persisted loop-edge ring
    # Sparse BoW entries kept per keyframe (top-T words by TF-IDF weight,
    # ops/bow.py sparse_bow): the place-recognition database is O(K*T),
    # independent of the vocabulary's size.  Exact while a frame has <= T
    # distinct words; beyond that the lowest-weight words are dropped.
    bow_top: int = 512


class TrackingConfig(NamedTuple):
    """The JAX package's TrackingConfig (tracking, local mapping, loop
    closing).  min_motion_matches, min_inliers_motion and nn_ratio are read
    by neither package; they are kept so that the same configurations build."""

    # Keyframe policy (reference Tracking::NeedNewKeyFrame, Tracking.cc:1509-1648)
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    kf_ref_ratio_stereo: float = 0.75
    kf_ref_ratio_mono: float = 0.9
    kf_min_close_points: int = 100
    kf_min_new_close: int = 70
    kf_attrition_ratio: float = 0.6
    # Matching (reference Tracking.cc:1353-1440, ORBmatcher radii)
    motion_search_radius: float = 15.0
    motion_search_radius_wide: float = 30.0
    local_search_radius: float = 3.0
    min_motion_matches: int = 20
    min_inliers_motion: int = 10
    min_inliers_local: int = 30
    # Depth handling
    depth_threshold_factor: float = 35.0     # close = depth < 35 * baseline
    max_new_points_per_kf: int = 100
    nn_ratio: float = 0.9
    min_init_depth_points: int = 100
    # RGB-D u_right information weight (sigma_ur = 1/sqrt(w) px)
    rgbd_ur_weight: float = 25.0
    # Monocular initialization gates.  The reference demands >= 100 matches
    # with its doubled init extractor (2x nFeatures, Tracking.cc:121); these
    # scale to the configured feature budget.
    mono_init_min_matches: int = 60
    mono_init_min_points: int = 40
    mono_init_min_parallax: float = 2.0  # degrees; reject low-baseline inits
    # mono keyframes must come faster: no depth seeds new points (reference
    # thRefRatio = 0.9 for mono against 0.75 for stereo, Tracking.cc:1575)
    kf_attrition_ratio_mono: float = 0.9
    # Global BA after each loop closure (reference RunGlobalBundleAdjustment)
    enable_loop_gba: bool = True
    # Keyframe culling: a covisible keyframe whose points are >= this share
    # observed by >= 3 other keyframes is retired (reference
    # LocalMapping::KeyFrameCulling 0.9, src/LocalMapping.cc:952)
    kf_cull_redundancy: float = 0.9
    # Covisibility-consistency chaining: a loop candidate's group must be
    # re-detected by this many consecutive keyframes before the correction
    # (reference mnCovisibilityConsistencyTh = 3, LoopClosing.cc:56, :229-305)
    loop_consistency_th: int = 3


class SlamConfig(NamedTuple):
    camera: CameraParams
    orb: OrbConfig = OrbConfig()
    caps: Capacities = Capacities()
    tracking: TrackingConfig = TrackingConfig()
    sensor: str = "rgbd"       # "mono" | "stereo" | "rgbd"
    depth_map_factor: float = 1.0
    # Trained BoW vocabulary (ops/bow.py) for relocalization; None disables
    # place recognition.  The System moves it to its device at construction.
    vocab: object = None
    # Stereo undistort-rectify maps (mx_l, my_l, mx_r, my_r), float32 [H, W]
    # each (numpy or torch), applied on the device to both eyes before
    # extraction (the reference's EuRoC path remaps with cv::remap before
    # tracking, Examples/Stereo/stereo_euroc.cc:45-80; maps from
    # utils/rectify.init_undistort_rectify_map).  None: the input is already
    # rectified.  The System moves them to its device at construction.
    rect_maps: object = None

    @property
    def ur_weight(self) -> float:
        return self.tracking.rgbd_ur_weight if self.sensor == "rgbd" else 1.0

    @property
    def bow_top(self) -> int:
        """Sparse-BoW row width: capped by the feature budget (a frame can
        never have more distinct words than features)."""
        return min(self.caps.bow_top, self.orb.feat_capacity())

    @property
    def th_depth(self) -> float:
        """Close/far point split: reference mThDepth = bf * ThDepth / fx."""
        return float(self.camera.bf / self.camera.fx * self.tracking.depth_threshold_factor)
