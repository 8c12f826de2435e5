"""Configuration for the video-stabilization engine.

The reference hard-codes its hyperparameters as compile-time constants scattered
through ``src/stabilizer.cpp`` (GFTT: :933-945, LK: :185-190, ORB: :483-493,
SIFT: :496-507, RANSAC: :510-511, ECC: :767-771).  Here they are lifted into one
typed, hashable config object so a single jitted step function can be specialized
per-config without recompiling on every call.

All sizes are static: XLA requires fixed shapes, so OpenCV's variable-length
feature vectors become fixed-capacity arrays with validity masks.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class StabilizationMode(enum.IntEnum):
    """Stabilization modes (reference: include/stabilizer.hpp:31-38).

    Values are stable integers because the mode is carried on-device as an
    ``int32`` and dispatched with ``lax.switch``.
    """

    GLOBAL_SMOOTHING = 0
    ACCUMULATED_FULL_LOCK = 1
    ORB_FULL_LOCK = 2
    SIFT_FULL_LOCK = 3
    TRANSLATION_LOCK = 4
    ROTATION_LOCK = 5


class InputMode(enum.Enum):
    """Input source selection (reference: src/main_utils.hpp:13-18)."""

    UNSPECIFIED = "unspecified"
    SIMULATOR = "simulator"
    CAMERA = "camera"
    FILE = "file"


@dataclasses.dataclass(frozen=True)
class GFTTConfig:
    """Shi-Tomasi good-features-to-track (reference: src/stabilizer.cpp:933-945)."""

    max_features: int = 1280          # ref uses 1300; rounded to a lane multiple
    quality_level: float = 0.01
    # min distance is 10 * (rows / 720) in the reference (:938-940); we keep the
    # same scaling rule, resolved at trace time from the working height.
    min_distance_at_720: float = 10.0
    block_size: int = 3
    gradient_size: int = 3
    # Corner-selection method (ops/gftt.py): "cell" = parallel cell-based
    # suppression (fastest); "cv2exact" = OpenCV's greedy response-ordered
    # min-distance suppression, reproduced exactly via a parallel MIS
    # fixpoint (decision-exact, not float-ULP-exact); "host" = the in-step
    # detector is skipped and the host injects ops/gftt_host.py's
    # element-exact numpy replica into the carry (requires the cv2exact
    # RANSAC host-estimator split — the drift-referee configuration).
    selection: str = "cell"
    # cv2exact: NMS survivors considered by the greedy pass (top-M by
    # response).  Exact iff the image has <= M survivors; 6144 covers 360p
    # scenes with wide margin (typical counts are 2-4k).
    max_candidates: int = 6144


@dataclasses.dataclass(frozen=True)
class LKConfig:
    """Pyramidal Lucas-Kanade (reference: src/stabilizer.cpp:185-190)."""

    window_size: int = 21
    pyramid_levels: int = 3           # maxLevel=3 => 4 levels total (0..3)
    max_iters: int = 50
    epsilon: float = 0.01
    min_eig_threshold: float = 1e-4
    # "dense":    all-stencil dense block matching + global-similarity
    #             chaining (the default; assumes globally-rigid
    #             inter-frame motion, which the engine's RANSAC fit
    #             assumes anyway).
    # "sweep":    per-point SSD-sweep + Newton polish (general scenes).
    # "cv2exact": per-point gradient-descent LK, zero-init, OpenCV's
    #             iteration schedule at every pyramid level — the fidelity
    #             referee for reference_compat drift benchmarks (slow).
    method: str = "dense"
    # Dense path: extra per-point Newton iterations at the exact subpixel
    # corner positions after the dense pipeline.  Default 0: on the bench
    # config-1 footage the polish improved corner drift vs analytic truth by
    # only 0.012 px (0.896 vs 0.908).  Its device cost on the GPU is not
    # measured.  The independent-motion saturation gate it also provided is
    # preserved by thresholding the sampled final-round dense delta
    # (ops/lk_dense.py).
    corner_polish_iters: int = 0


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Robust similarity fit (reference: src/stabilizer.cpp:224-225, 510-511,
    and OpenCV estimateAffinePartial2D defaults)."""

    num_hypotheses: int = 256         # fixed hypothesis count (static shapes)
    inlier_threshold: float = 3.0     # px, OpenCV default ransacReprojThreshold
    lock_inlier_threshold: float = 5.0  # ORB/SIFT lock path uses 5.0 (:510-511)
    refine_iters: int = 2             # least-squares refits on the inlier set
    min_points: int = 10              # MIN_POINTS_FOR_MOTION_ESTIMATION (:20)
    # Inter-frame motion family (models.motion_models): "rigid" is the
    # reference's de-scaled similarity (src/stabilizer.cpp:261-267);
    # "similarity" / "affine" / "homography" enable the richer fits (the
    # reference carries the homography path disabled, :227-229).
    motion_model: str = "rigid"
    # "vmapped":  the batched-hypothesis sweep above (default).
    # "cv2exact": bit-exact replica of cv2.estimateAffinePartial2D's RANSAC
    #             (motion/cv2_ransac.py — OpenCV's MWC RNG hypothesis stream,
    #             sequential early exit, LM polish), run as a HOST estimator
    #             stage between two jitted halves of the step.  Fidelity
    #             referee for reference_compat drift benchmarks; rigid model
    #             only.
    method: str = "vmapped"


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB detect/describe (reference: src/stabilizer.cpp:483-493)."""

    max_features: int = 2560          # ref 2500; rounded up to lane multiple
    scale_factor: float = 1.2
    n_levels: int = 12
    edge_threshold: int = 31
    patch_size: int = 31
    fast_threshold: int = 20
    lowe_ratio: float = 0.6
    max_keypoint_size_ratio: float = 0.10
    # BRIEF test-pair table: "cv2" = OpenCV's learned 256-pair pattern
    # (bit_pattern_31_, recovered bit-exactly by
    # benchmarks/extract_orb_pattern.py into ops/orb_pattern.py — the
    # reference inherits it via cv::ORB, src/stabilizer.cpp:483-493);
    # "brief" = the original seeded-Gaussian BRIEF construction.
    pattern: str = "cv2"


@dataclasses.dataclass(frozen=True)
class SIFTConfig:
    """SIFT detect/describe (reference: src/stabilizer.cpp:496-507)."""

    max_features: int = 2560          # ref 2500
    n_octave_layers: int = 3
    contrast_threshold: float = 0.04
    edge_threshold: float = 5.0
    sigma: float = 1.2
    max_keypoint_size_ratio: float = 0.05
    # SIFT match filter keeps distance <= max(0.5*avg, 0.02) (:698-702)
    match_avg_ratio: float = 0.5
    match_min_distance: float = 0.02
    # cv2-parity options (both default off — the engine's SIFT lock is
    # self-consistent; enable for statistical descriptor parity with
    # cv::SIFT as used by the reference, src/stabilizer.cpp:496-507):
    # upsample_2x: cv2's initial 2x image upsampling (a -1 octave of
    # fine-scale keypoints; doubles scale-space cost).
    upsample_2x: bool = False
    # multi_orientation: emit a second keypoint at orientation-histogram
    # peaks >= peak_ratio * max (cv2's SIFT_ORI_PEAK_RATIO = 0.8).
    multi_orientation: bool = False
    ori_peak_ratio: float = 0.8


@dataclasses.dataclass(frozen=True)
class ECCConfig:
    """ECC Euclidean refinement (reference: src/stabilizer.cpp:760-782).

    Disabled in the reference "for performance reasons"; we can afford it."""

    enabled: bool = False
    max_iters: int = 100
    epsilon: float = 0.001


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """ORB/SIFT preprocessing chain (reference: src/stabilizer.cpp:464-477,
    docs/math-overview.md:323-328): median5 -> sharpen3x3 -> CLAHE -> median5."""

    median_ksize: int = 5
    clahe_clip_limit: float = 2.0
    clahe_tiles: Tuple[int, int] = (8, 8)


@dataclasses.dataclass(frozen=True)
class StabilizerConfig:
    """Top-level engine configuration.

    ``past_frames`` / ``future_frames`` are the temporal window sides in frames
    (reference: Stabilizer ctor, include/stabilizer.hpp:137; the app derives
    them as window-seconds x fps, src/main.cpp:205-207).
    """

    past_frames: int = 60             # 2.0 s @ 30 fps
    future_frames: int = 45           # 1.5 s @ 30 fps
    working_height: int = 360
    # Full-resolution frame geometry (static; the reference errors on mid-stream
    # size changes too, src/stabilizer.cpp:111-113).
    frame_height: int = 720
    frame_width: int = 1280
    channels: int = 3

    gftt: GFTTConfig = GFTTConfig()
    lk: LKConfig = LKConfig()
    ransac: RansacConfig = RansacConfig()
    orb: ORBConfig = ORBConfig()
    sift: SIFTConfig = SIFTConfig()
    ecc: ECCConfig = ECCConfig()
    preprocess: PreprocessConfig = PreprocessConfig()

    # Replicate the reference's behavioral quirks bit-for-bit (SURVEY.md §7
    # "Matching the reference's quirks") — used only by drift benchmarks.
    reference_compat: bool = False

    # Pin the stabilization mode at trace time.  None (default) keeps the
    # reference's runtime mode switching (lax.switch on the carried mode) —
    # correct single-stream, but under vmap a batched switch runs EVERY
    # branch for every stream (ORB + SIFT + accumulated, ~5x the step).
    # Stream-batched throughput paths set this to the int StabilizationMode
    # so only one branch is traced.
    static_mode: int | None = None

    # Compute dtype for image ops (3x3 transform math is always f32).
    image_dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.past_frames < 0 or self.future_frames < 0:
            raise ValueError("window sides must be non-negative")
        if self.past_frames == 0 and self.future_frames == 0:
            # reference: src/stabilizer.cpp:40-41
            raise ValueError("past and future frame windows cannot both be zero")
        if not (90 < self.working_height <= 2160):
            # reference: src/stabilizer.cpp:44-49
            raise ValueError("working_height must be in (90, 2160]")
        if self.frame_height <= 10 or self.frame_width <= 10:
            # reference rejects frames <= 10x10 (src/stabilizer.cpp:99-103)
            raise ValueError("frame size must exceed 10x10")

    @property
    def total_window(self) -> int:
        """past + 1 + future (reference: include/stabilizer.hpp:196-198)."""
        return self.past_frames + 1 + self.future_frames

    @property
    def scale_factor(self) -> float:
        """working_height / frame_height (reference: src/stabilizer.cpp:117-119)."""
        return self.working_height / self.frame_height

    @property
    def working_size(self) -> Tuple[int, int]:
        """(height, width) at working resolution, preserving aspect ratio."""
        h = self.working_height
        w = int(round(self.frame_width * self.scale_factor))
        return (h, w)


DEFAULT_CONFIG = StabilizerConfig()
