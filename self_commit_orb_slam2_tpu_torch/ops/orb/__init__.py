"""ORB feature extraction: pyramid, FAST, orientation, rotated BRIEF
(counterpart of the JAX package's ops/orb; reference src/ORBextractor.cc)."""

from .extractor import OrbConfig, OrbFeatures, build_extractor  # noqa: F401
