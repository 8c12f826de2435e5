"""video_stabilization — a JAX/XLA video-stabilization framework.

A ground-up re-design of the capabilities of the reference C++/OpenCV project
``joao-gueifao-924/Video-Stabilization`` (see SURVEY.md) as a pure-functional,
fixed-shape, jit-compiled streaming pipeline:

    (carry, frame) -> (carry, stabilized_frame)

where ``carry`` is an explicit pytree (ring buffers of inter-frame transforms and
frames, reference-lock state, accumulator), batched over independent video
streams with ``vmap`` and sharded over device meshes with ``jax.sharding``.

Subpackages
-----------
- ``motion``   : homography parameterization (decompose/compose), similarity
                 fitting, RANSAC — the motion-model math core.
- ``ops``      : image/vision kernels (pyramids, Shi-Tomasi, pyramidal LK,
                 warping, filtering, FAST/ORB, SIFT, ECC) as XLA code.
- ``sim``      : JAX ray-cast floor-texture camera simulator — the ground-truth
                 test harness (reference: src/camera_engine.cpp).
- ``engine``   : the stabilization engine — carry pytree, per-frame step
                 function, temporal-window smoothing, lock modes.
- ``parallel`` : device meshes, stream sharding, multi-chip execution.
- ``io``       : host-side video decode/encode and device feeding.
- ``cli``      : command-line application mirroring the reference's flags.
- ``utils``    : timing, profiling, logging.
"""

__version__ = "0.1.0"

from video_stabilization.config import (  # noqa: F401
    StabilizationMode,
    StabilizerConfig,
)


def __getattr__(name):
    # Lazy top-level conveniences (importing the engine pulls in all kernels;
    # keep bare `import video_stabilization` light).
    if name == "Stabilizer":
        from video_stabilization.engine import Stabilizer

        return Stabilizer
    raise AttributeError(name)
