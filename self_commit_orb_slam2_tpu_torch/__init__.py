"""PyTorch + CUDA port of the visual SLAM engine, for one NVIDIA H100.

The JAX package `self_commit_orb_slam2_tpu` is the reference this package is
held against; nothing here imports it (or JAX).  The layout mirrors it module
for module (`ops/se3.py`, `ops/orb/...`, `models/...`) so every function has
an obvious counterpart, and the state keeps the JAX field names (`MapState`,
`TrackCarry`, `FrameData`, `StepInfo`) so `convert.py` can move a map between
the two packages field by field.

It covers the three sensors (RGB-D, stereo, monocular): ORB extraction
(with the two FAST kernels as hand-written CUDA: the band kernel
`csrc/fast_band.cu` for 16-px cells, the NMS kernel `csrc/fast_nms.cu` for
any other cell size), depth association or stereo matching, the monocular
two-view bootstrap, dual-hypothesis motion tracking, local-map tracking, the
keyframe decision, keyframe insertion and, when enabled, local mapping
(triangulation, fusion, local bundle adjustment, point and keyframe
culling).  With a vocabulary (`ops/bow.py`; the bundled one is read in place
from the JAX package's assets directory) keyframes carry BoW rows, a lost
tracker relocalizes (`models/relocalization.py`, `ops/solvers/`),
localization mode tracks against a fixed map, maps are saved and loaded as
checkpoints either package reads, and loops close (`models/loop_closing.py`:
BoW detection, Sim3 RANSAC and polish, the essential-graph pose graph, the
loop fuse, the global BA in slices).

Entry points run on `cuda` unless the caller passes `device="cpu"`.  On the
CPU every kernel wrapper takes its plain PyTorch version; on the card it
launches its kernel or raises.
"""

import torch as _torch

# SLAM geometry needs true fp32 products (the JAX package sets "highest"
# matmul precision for the same reason); TF32 keeps ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
