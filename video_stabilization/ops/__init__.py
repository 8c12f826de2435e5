"""Vision/image kernels for the stabilization pipeline.

All ops are pure jnp/XLA, operate on float32 image arrays with static
shapes, and are written to match OpenCV's sampling conventions closely
enough that fidelity tests compare against ``cv2`` outputs directly
(tests/test_ops.py and friends).
"""

from video_stabilization.ops.image import (  # noqa: F401
    bgr_to_gray,
    resize_bilinear,
    resize_nearest,
    yuv_flat_to_bgr,
    yuv_planes_to_bgr,
)
from video_stabilization.ops.warp import (  # noqa: F401
    warp_affine,
    warp_perspective,
)
from video_stabilization.ops.pyramid import (  # noqa: F401
    build_pyramid,
    pyr_down,
)
from video_stabilization.ops.gftt import (  # noqa: F401
    Corners,
    good_features_to_track,
    min_eig_response,
)
from video_stabilization.ops.lk import (  # noqa: F401
    LKResult,
    lk_track,
    lk_track_sweep,
)
from video_stabilization.ops.lk_dense import lk_track_dense  # noqa: F401
from video_stabilization.ops.filters import (  # noqa: F401
    clahe,
    median_blur,
    preprocess_for_registration,
    sharpen3,
)
from video_stabilization.ops.fast import fast_score  # noqa: F401
from video_stabilization.ops.orb import (  # noqa: F401
    ORBFeatures,
    orb_detect_and_compute,
)
from video_stabilization.ops.sift import (  # noqa: F401
    SIFTFeatures,
    sift_detect_and_compute,
)
from video_stabilization.ops.match import (  # noqa: F401
    Matches,
    match_hamming_knn,
    match_l2,
)
from video_stabilization.ops.ecc import (  # noqa: F401
    ECCResult,
    ecc_refine_euclidean,
)
from video_stabilization.ops.compositing import (  # noqa: F401
    compute_translation_shift,
    copy_feathered,
    warped_mask,
)
