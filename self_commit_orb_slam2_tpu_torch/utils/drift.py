"""Synthetic odometry-drift injection for loop-closing runs.

Counterpart of the JAX package's utils/drift.py.  The synthetic renderer is
noiseless, so tracking accumulates no natural drift over a re-traversed
loop; these helpers displace all map content older than the newest few
keyframes by a small similarity increment per call, so content created at
keyframe j accumulates dD^(n-j) along the chain, like integrated odometry
error, until a loop closure bends the map back (reference
src/LoopClosing.cc:571-880).  One elementwise pass on the map's device, no
host round trip.
"""

from __future__ import annotations

import functools

import torch

from ..models.map_state import MapState
from ..ops import se3


def displace_old_content(m: MapState, dD, scale, keep_recent: int = 6) -> MapState:
    """One drift increment: world content older than the newest
    `keep_recent` keyframes moves by the similarity (scale, dD [4, 4]).

    Points:     p'   = scale * (R p + t)
    Keyframes:  R'cw = Rcw R^T,  t'cw = scale * (tcw - Rcw R^T t)
    so the moved pose sees the moved content at the original pixels with
    depth scaled by `scale`: the old sector stays consistent but displaced
    (and, for mono scale drift, re-scaled)."""
    dev = m.kf_Tcw.device
    dD = torch.as_tensor(dD, dtype=torch.float32, device=dev)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    cutoff = torch.max(torch.where(m.kf_valid, m.kf_seq, -1)) - keep_recent
    kf_sel = (m.kf_seq >= 0) & (m.kf_seq <= cutoff) & m.kf_valid
    pt_sel = (m.pt_first_kf <= cutoff) & m.pt_valid

    R, t = dD[:3, :3], dD[:3, 3]
    p_new = scale * (m.pt_pos @ R.T + t)
    n_new = m.pt_normal @ R.T
    Rcw = m.kf_Tcw[:, :3, :3]
    tcw = m.kf_Tcw[:, :3, 3]
    Rcw_new = torch.einsum("kij,lj->kil", Rcw, R)                    # Rcw R^T
    # x_cam' = R'cw p' + t'cw = s Rcw p + s Rcw R^T t + t'cw = s x_cam
    tcw_new = scale * (tcw - torch.einsum("kij,j->ki", Rcw_new, t))
    T_new = se3.rt_to_mat(Rcw_new, tcw_new)
    return m._replace(
        kf_Tcw=torch.where(kf_sel[:, None, None], T_new, m.kf_Tcw),
        pt_pos=torch.where(pt_sel[:, None], p_new, m.pt_pos),
        pt_normal=torch.where(pt_sel[:, None], n_new, m.pt_normal))


def make_injector(keep_recent: int = 6):
    """displace_old_content with keep_recent bound: injector(map, dD, scale)."""
    return functools.partial(displace_old_content, keep_recent=keep_recent)


def se3_increment(twist) -> torch.Tensor:
    """Small SE3 increment [4, 4] from a 6-vector (t, omega) (host convenience)."""
    return se3.se3_exp(torch.as_tensor(twist, dtype=torch.float32))
