"""Motion-model math: homography parameterization, similarity fitting, RANSAC."""

from video_stabilization.motion.homography import (  # noqa: F401
    HomographyParams,
    compose_homography,
    decompose_homography,
    identity_homography,
    qr_2x2,
    remove_isotropic_scale,
)
from video_stabilization.motion.similarity import (  # noqa: F401
    fit_similarity_masked,
    similarity_from_2pt,
)
from video_stabilization.motion.ransac import (  # noqa: F401
    estimate_similarity_ransac,
)
