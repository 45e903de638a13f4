"""The loop scenario of chip_smoke.py path 6, through the JAX package on the CPU.

    python scripts/jax_loop_scenario.py [frames_per_rev n_frames drift_from drift_to]

Defaults 120 184 9 120: bench.py's default RGB-D configuration with the
bundled vocabulary and loop closing on (System(cfg)), a circle trajectory
rendered by generate_sequence(seed=5), streamed in chunks of 4, with
bench.py's per-frame drift twist composed over each chunk and injected
after every chunk whose last frame lies in [drift_from, drift_to].  Prints
each closure's frame and a JSON line: closures, keyframes, the global BA's
path, the corrected ATE (get_trajectory) and the raw per-frame poses' ATE.
The port runs the same drive in chip_smoke.py (phase_path6).
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
DRIFT_TWIST = [0.0011, 0.00028, -0.00055, 0.0, 0.0009, 0.0]   # bench.py:451-452


def main(rev: int, n: int, drift_from: int, drift_to: int) -> dict:
    t0 = time.time()
    seq = generate_sequence(n_frames=n, width=WIDTH, height=HEIGHT, fx=FX, seed=5,
                            trajectory=circle_trajectory(n, frames_per_rev=rev))
    cam = CameraParams.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=FX * 0.1,
                              width=WIDTH, height=HEIGHT)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=1000),
                     caps=Capacities(max_keyframes=64, max_points=16384, local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=10), sensor="rgbd",
                     vocab=load_vocabulary(_default_vocab_path()))
    slam = System(cfg)
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    depths = np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16)
    dD = np.linalg.matrix_power(np.asarray(se3_increment(DRIFT_TWIST), np.float64), CHUNK)
    dD = jnp.asarray(dD.astype(np.float32))
    inject = make_injector(keep_recent=6)
    sess = slam.open_stream("rgbd", CHUNK)
    sess.feed((images[:1 + CHUNK], depths[:1 + CHUNK]), seq.timestamps[:1 + CHUNK])
    done, fired = 1 + CHUNK, []
    while done < n:
        sl = slice(done, min(done + CHUNK, n))
        sess.feed((images[sl], depths[sl]), seq.timestamps[sl])
        done = sl.stop
        if drift_from <= done <= drift_to:
            slam.map = inject(slam.map, dD, jnp.float32(1.0))
        sess.poll()
        if slam._loop_closer.n_big_changes > len(fired):
            fired.append(done)
            print("closure at frame", done, flush=True)
    sess.finish()
    _, est = slam.get_trajectory()
    raw = np.stack([p for _, p in slam.trajectory])
    return dict(frames_per_rev=rev, frames=n, drift=[drift_from, drift_to],
                closures=slam._loop_closer.n_big_changes, fired_in_stream=fired,
                keyframes=slam.n_keyframes(), state=slam.state,
                gba=slam._loop_closer.last_gba_info,
                ate_corrected=float(ate_rmse(est, seq.poses_gt[:len(est)])),
                ate_raw=float(ate_rmse(raw, seq.poses_gt[:len(raw)])),
                seconds=time.time() - t0)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:5]] or [120, 184, 9, 120]
    print(json.dumps(main(*args)))
