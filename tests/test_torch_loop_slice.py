"""One whole loop through the port's streamed path, held against the JAX
package's outcome on the same frames.

A 320x240 spin (72 frames a revolution, 88 frames) with the bundled
vocabulary and System(cfg)'s defaults (loop closing, global BA, consistency
3), streamed in chunks of 4 through open_stream / feed / poll, with gradual
drift injected between feeds through utils/drift (keep_recent=6; per chunk
the JAX drift test's per-frame twist composed 8 times) from frame 8 until
the revisit at frame 72.  The JAX side costs too much for every run of the
tests; its outcome, from `python tests/test_torch_loop_slice.py` (the same
drive through the JAX package on the CPU), is kept below.

Required of the port: a closure inside the stream and none lost tracking;
the JAX drift test's bounds for gradual drift (corrected ATE < 0.8 x the
raw per-frame ATE and < 0.18 m, tests/test_loop_closing.py:188-190); against
the JAX run, the same number of closures, keyframes within 5 and corrected
ATE within 0.04 m.  The two packages consume a detection at different
points (the JAX closer when its fetch is ready, here in the drain that
dispatched it; models/loop_closing.py), so the stream closes at a different
frame and the raw ATEs differ; the outcome is what is compared.
"""

import pathlib
import sys

import numpy as np
import torch

torch.set_num_threads(2)   # six test workers share the CPU

N, REV, CHUNK = 88, 72, 4
DRIFT_FROM, DRIFT_TO, POW = 8, 72, 8
TWIST = [0.0012, 0.0003, -0.0006, 0.0, 0.001, 0.0]   # tests/test_loop_closing.py:175

# python tests/test_torch_loop_slice.py (JAX package, CPU)
JAX_OUTCOME = dict(closures=1, keyframes=38, ate_corrected=0.125053, ate_raw=0.216110)


def scenario(package: str) -> dict:
    """The drive, through the port ("port", on the CPU) or the JAX package."""
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence, spin_trajectory

    if package == "jax":
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_platforms", "cpu")
        from self_commit_orb_slam2_tpu.models import config
        from self_commit_orb_slam2_tpu.models.system import System
        from self_commit_orb_slam2_tpu.ops import bow, camera, se3
        from self_commit_orb_slam2_tpu.ops.orb import extractor
        from self_commit_orb_slam2_tpu.run_slam import _default_vocab_path
        from self_commit_orb_slam2_tpu.utils.drift import make_injector

        vocab = bow.load_vocabulary(_default_vocab_path())
        dD = jnp.asarray(np.linalg.matrix_power(
            np.asarray(se3.se3_exp(jnp.asarray(TWIST, jnp.float32)), np.float64), POW)
            .astype(np.float32))
        scale, kw = jnp.float32(1.0), {}
    else:
        from self_commit_orb_slam2_tpu_torch.models import config
        from self_commit_orb_slam2_tpu_torch.models.system import System
        from self_commit_orb_slam2_tpu_torch.ops import bow, camera
        from self_commit_orb_slam2_tpu_torch.ops.orb import extractor
        from self_commit_orb_slam2_tpu_torch.utils.drift import make_injector, se3_increment

        vocab = bow.load_vocabulary(bow.default_vocab_path())
        dD = torch.linalg.matrix_power(se3_increment(TWIST).double(), POW).float()
        scale, kw = 1.0, dict(device="cpu")
    cfg = config.SlamConfig(
        camera=camera.CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0,
                                          width=320, height=240),
        orb=extractor.OrbConfig(n_features=500),
        caps=config.Capacities(max_keyframes=48, max_points=8192, local_points=1024),
        tracking=config.TrackingConfig(max_frames_between_kf=6), sensor="rgbd", vocab=vocab)
    seq = generate_sequence(n_frames=N, width=320, height=240, seed=9,
                            trajectory=spin_trajectory(N, frames_per_rev=REV))
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    depths = np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16)
    inject = make_injector(keep_recent=6)
    slam = System(cfg, **kw)
    sess = slam.open_stream("rgbd", CHUNK)
    sess.feed((images[:1 + CHUNK], depths[:1 + CHUNK]), seq.timestamps[:1 + CHUNK])
    done = 1 + CHUNK
    while done < N:
        sl = slice(done, min(done + CHUNK, N))
        sess.feed((images[sl], depths[sl]), seq.timestamps[sl])
        done = sl.stop
        if DRIFT_FROM <= done <= DRIFT_TO:
            slam.map = inject(slam.map, dD, scale)
        sess.poll()
    sess.finish()
    _, est = slam.get_trajectory()
    raw = np.stack([T for _, T in slam.trajectory])
    return dict(closures=slam._loop_closer.n_big_changes, keyframes=slam.n_keyframes(),
                state=slam.state, ate_corrected=float(ate_rmse(est, seq.poses_gt)),
                ate_raw=float(ate_rmse(raw, seq.poses_gt)),
                gba=dict(slam._loop_closer.last_gba_info))


def test_streamed_loop_closes_and_corrects_like_the_jax_package():
    got = scenario("port")
    assert got["state"] == 1 and got["closures"] == JAX_OUTCOME["closures"] >= 1
    assert got["gba"].get("gba_path") == "dense"
    assert got["ate_corrected"] < 0.8 * got["ate_raw"] and got["ate_corrected"] < 0.18
    assert abs(got["keyframes"] - JAX_OUTCOME["keyframes"]) <= 5
    assert abs(got["ate_corrected"] - JAX_OUTCOME["ate_corrected"]) <= 0.04


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    print(scenario(sys.argv[1] if len(sys.argv) > 1 else "jax"))
