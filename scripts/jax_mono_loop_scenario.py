"""The mono scale-drift loop of chip_smoke.py path 9 (a), through the JAX package on the CPU.

    python scripts/jax_mono_loop_scenario.py [--bench-bf | --port] [frames_per_rev n_frames drift_to]

Defaults 120 180 120: bench.py's mono configuration (bench_long_mono,
bench.py:561-574: 640x480, fx 520, 1000 features, capacities 96 / 16384 /
1024, max_frames_between_kf=10, the bundled vocabulary) on a circle
trajectory rendered by generate_sequence(seed=5), streamed through
open_stream("mono") in chunks of 4.  bench.py's per-frame similarity drift
(twist and scale 1.0006, bench.py:575-577), composed over each chunk, is
injected through make_injector(keep_recent=6) after every chunk fed while
tracking is OK, from the first chunk after initialization until frame
drift_to.  The same frames and drift run once with loop closing and once
without.  Prints the frame at which each closure landed (several can land
in one drain) and its Sim3 scale, then a JSON line: the
closures, live keyframes and both runs' Sim3-aligned ATE against the
trailing ground truth (bench.py:615-618).  The port runs the same drive in
chip_smoke.py (phase_path9a).

The camera's bf is 0 by default, where bench.py sets 0.1 fx.  The JAX
package picks triangulation's baseline gate by bf > 0, the port (as the
reference) by the sensor, so with bf = 0 both packages triangulate a mono
map under the same rule and this run sets like beside like with the port's
bench.py configuration.  --bench-bf runs bench.py's bf = 0.1 fx, which
gives the JAX package's mono map the stereo rule (a keyframe baseline above
0.1 map units).  --port drives the same frames and drift through the port
on the CPU instead (bf = 0.1 fx, as chip_smoke.py runs it on the card), so
the card's outcome can be told apart from what the CPU's draws give.
"""

import json
import pathlib
import sys
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from self_commit_orb_slam2_tpu.models.config import (  # noqa: E402
    Capacities, SlamConfig, TrackingConfig)
from self_commit_orb_slam2_tpu.models.system import System  # noqa: E402
from self_commit_orb_slam2_tpu.ops.bow import load_vocabulary  # noqa: E402
from self_commit_orb_slam2_tpu.ops.camera import CameraParams  # noqa: E402
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig  # noqa: E402
from self_commit_orb_slam2_tpu.run_slam import _default_vocab_path  # noqa: E402
from self_commit_orb_slam2_tpu.utils.drift import make_injector, se3_increment  # noqa: E402
from self_commit_orb_slam2_tpu.utils.evaluation import ate_rmse  # noqa: E402
from self_commit_orb_slam2_tpu.utils.synthetic import (  # noqa: E402
    circle_trajectory, generate_sequence)

WIDTH, HEIGHT, FX, CHUNK = 640, 480, 520.0, 4
MONO_TWIST = [0.0009, 0.0002, -0.0004, 0.0, 0.0007, 0.0]   # bench.py:575-576
MONO_SCALE = 1.0006                                        # bench.py:577


def run(seq, cfg, n: int, drift_to: int, loops: bool) -> dict:
    slam = System(cfg, enable_loop_closing=loops)
    scales, fired = [], []
    if loops:
        lc = slam._loop_closer
        correct = lc._jit_correct

        def spy(m, kf, det):
            scales.append(float(det.S_cur_cand[7]))
            return correct(m, kf, det)

        lc._jit_correct = spy
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    dD = np.linalg.matrix_power(np.asarray(se3_increment(MONO_TWIST), np.float64), CHUNK)
    dD = jnp.asarray(dD.astype(np.float32))
    s_c = jnp.float32(MONO_SCALE ** CHUNK)
    inject = make_injector(keep_recent=6)
    sess = slam.open_stream("mono", CHUNK)
    done, init_at = 0, None
    while done < n:
        sl = slice(done, min(done + CHUNK, n))
        was_init = slam.state == 1
        sess.feed((images[sl],), seq.timestamps[sl])
        done = sl.stop
        if init_at is None and slam.state == 1:
            init_at = done
        if was_init and done <= drift_to and slam.state == 1:
            slam.map = inject(slam.map, dD, s_c)
        sess.poll()
        while loops and slam._loop_closer.n_big_changes > len(fired):
            fired.append(done)
            print(f"closure landed at frame {done}, Sim3 scale {scales[len(fired) - 1]:.6f}",
                  flush=True)
    sess.finish()
    _, est = slam.get_trajectory()
    gt = seq.poses_gt[n - len(est):n]
    return dict(closures=slam._loop_closer.n_big_changes if loops else 0, fired_at=fired,
                scales=scales, initialized_at=init_at, state=slam.state,
                keyframes=slam.n_keyframes(), live=int(np.asarray(slam.map.kf_valid).sum()),
                gba=slam._loop_closer.last_gba_info if loops else None,
                ate_sim3=float(ate_rmse(est, gt, with_scale=True)), n_poses=len(est))


def run_port(seq, n: int, drift_to: int, loops: bool) -> dict:
    """run() through the port on the CPU, with bench.py's bf."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import config as tconfig
    from self_commit_orb_slam2_tpu_torch.models.system import System as TSystem
    from self_commit_orb_slam2_tpu_torch.ops import bow as tbow
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams as TCam
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig as TOrb
    from self_commit_orb_slam2_tpu_torch.utils import drift as tdrift
    from self_commit_orb_slam2_tpu_torch.utils import evaluation as teval

    cam = TCam.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=FX * 0.1, width=WIDTH,
                      height=HEIGHT)
    cfg = tconfig.SlamConfig(
        camera=cam, orb=TOrb(n_features=1000),
        caps=tconfig.Capacities(max_keyframes=96, max_points=16384, local_points=1024),
        tracking=tconfig.TrackingConfig(max_frames_between_kf=10), sensor="mono",
        vocab=tbow.load_vocabulary(tbow.default_vocab_path()))
    slam = TSystem(cfg, enable_loop_closing=loops, device="cpu")
    lc = slam._loop_closer
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    dD = torch.linalg.matrix_power(tdrift.se3_increment(MONO_TWIST).double(), CHUNK).float()
    inject = tdrift.make_injector(keep_recent=6)
    sess = slam.open_stream("mono", CHUNK)
    done, init_at, fired = 0, None, []
    while done < n:
        sl = slice(done, min(done + CHUNK, n))
        was_init = slam.state == 1
        sess.feed((images[sl],), seq.timestamps[sl])
        done = sl.stop
        if init_at is None and slam.state == 1:
            init_at = done
        if was_init and done <= drift_to and slam.state == 1:
            slam.map = inject(slam.map, dD, MONO_SCALE ** CHUNK)
        sess.poll()
        while loops and lc.n_big_changes > len(fired):
            fired.append(done)
            print(f"closure landed at frame {done}", flush=True)
    sess.finish()
    _, est = slam.get_trajectory()
    gt = seq.poses_gt[n - len(est):n]
    return dict(closures=lc.n_big_changes if loops else 0, fired_at=fired,
                scales=[float(d.S_cur_cand[7]) for d in lc.corrections] if loops else [],
                initialized_at=init_at, state=slam.state, keyframes=slam.n_keyframes(),
                live=int(slam.map.kf_valid.sum()),
                gba=lc.last_gba_info if loops else None,
                ate_sim3=float(teval.ate_rmse(est, gt, with_scale=True)), n_poses=len(est))


def main(rev: int, n: int, drift_to: int, bf: float, port: bool = False) -> dict:
    t0 = time.time()
    seq = generate_sequence(n_frames=n, width=WIDTH, height=HEIGHT, fx=FX, seed=5,
                            trajectory=circle_trajectory(n, frames_per_rev=rev))
    cam = CameraParams.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=bf,
                              width=WIDTH, height=HEIGHT)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=1000),
                     caps=Capacities(max_keyframes=96, max_points=16384, local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=10), sensor="mono",
                     vocab=load_vocabulary(_default_vocab_path()))
    if port:
        with_loops, without = (run_port(seq, n, drift_to, loops) for loops in (True, False))
    else:
        with_loops, without = (run(seq, cfg, n, drift_to, loops) for loops in (True, False))
    return dict(frames_per_rev=rev, frames=n, drift_to=drift_to, bf=bf,
                package="port" if port else "jax", loop=with_loops,
                no_loop=without, seconds=time.time() - t0)


if __name__ == "__main__":
    argv = sys.argv[1:]
    port = "--port" in argv
    bf = FX * 0.1 if "--bench-bf" in argv or port else 0.0
    args = [int(a) for a in argv if not a.startswith("--")][:3] or [120, 180, 120]
    print(json.dumps(main(*args, bf=bf, port=port)))
