"""Dataset driver CLI: the counterpart of the reference's Examples/ programs.

The port's version of the JAX package's run_slam.py, with the same options,
per-dataset configurations and report, plus --device:

  python -m self_commit_orb_slam2_tpu_torch.run_slam --synthetic --frames 60
  python -m self_commit_orb_slam2_tpu_torch.run_slam --dataset tum   --path <dir> --settings TUM1.yaml
  python -m self_commit_orb_slam2_tpu_torch.run_slam --dataset kitti --path <seq_dir>
  python -m self_commit_orb_slam2_tpu_torch.run_slam --dataset euroc --path <dir> --settings EuRoC.yaml

The engine runs on the card unless --device cpu is given.  Like the
reference drivers (Examples/Monocular/mono_tum.cc:80-125) it prints
median/mean tracking time and writes a TUM-format trajectory; with ground
truth available it also reports ATE RMSE.  One more line splits the run's
seconds between decoding the frames and tracking them (synchronized with
the card on both sides) and gives the final tracking state.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["tum", "kitti", "euroc"], default=None)
    ap.add_argument("--path", default=None)
    ap.add_argument("--settings", default=None)
    ap.add_argument("--vocab", default=None, help="trained vocabulary .npz "
                    "(default: the bundled vocabulary, like the reference's "
                    "ORBvoc.txt; see scripts/train_vocab.py)")
    ap.add_argument("--no-vocab", action="store_true",
                    help="disable BoW (no loop closing / relocalization)")
    ap.add_argument("--sensor", choices=["auto", "mono", "stereo", "rgbd"],
                    default="auto", help="override the dataset's native sensor "
                    "(mono_* driver parity: reference Examples/Monocular)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--output", default="trajectory_tum.txt")
    ap.add_argument("--kitti-output", default=None)
    ap.add_argument("--localization", action="store_true")
    ap.add_argument("--batch", type=int, default=0,
                    help="process frames in device batches of this size")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda; cpu on purpose)")
    args = ap.parse_args(argv)

    from .models.config import Capacities, SlamConfig, TrackingConfig
    from .models.system import System, resolve_device
    from .ops import bow
    from .ops.camera import CameraParams
    from .ops.orb.extractor import OrbConfig
    from .utils.profiling import StageTimer

    device = resolve_device(args.device)
    timer = StageTimer(cuda=device.type == "cuda")
    vocab = None
    if not args.no_vocab:
        path = args.vocab or bow.default_vocab_path()
        if path:
            vocab = bow.load_vocabulary(path)
        elif args.vocab:
            ap.error(f"vocabulary not found: {args.vocab}")

    if args.synthetic:
        from .utils.synthetic import generate_sequence

        sensor = "rgbd" if args.sensor == "auto" else args.sensor
        with timer("decode"):
            seq = generate_sequence(n_frames=args.frames, width=320, height=240, seed=5)
        # mono: no baseline, more features, tighter keyframe policy (the
        # reference's mono init also extracts 2x features, Tracking.cc:387)
        cam = CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                  bf=0.0 if sensor == "mono" else 26.0,
                                  width=320, height=240)
        cfg = SlamConfig(
            camera=cam,
            orb=OrbConfig(n_features=700 if sensor == "mono" else 500),
            caps=Capacities(max_keyframes=128, max_points=32768),
            tracking=TrackingConfig(max_frames_between_kf=8 if sensor == "mono" else 10,
                                    kf_ref_ratio_stereo=0.8 if sensor == "mono" else 0.9),
            sensor=sensor, vocab=vocab)
        slam = System(cfg, device=device)
        if args.localization:
            slam.activate_localization_mode()
        if sensor == "mono":
            frames = [(seq.images[i], float(seq.timestamps[i]))
                      for i in range(args.frames)]
        else:
            frames = [(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
                      for i in range(args.frames)]
        gt = seq.poses_gt
    elif args.dataset == "tum":
        from .utils.config_io import load_settings
        from .utils.datasets import TumRgbdDataset

        sensor = "rgbd" if args.sensor == "auto" else args.sensor
        cfg = load_settings(args.settings, sensor=sensor, vocab=vocab)
        # the loader scales the depth PNGs to metres with the settings'
        # DepthMapFactor, so the engine takes metres on both of its paths (the
        # JAX driver hands raw counts to the engine and scales there; its
        # batch path quantizes metres to millimetres first, which clips raw
        # counts: a fault of that driver, not reproduced here)
        ds = TumRgbdDataset(args.path, depth_factor=1.0 / cfg.depth_map_factor)
        cfg = cfg._replace(depth_map_factor=1.0)
        slam = System(cfg, device=device)
        with timer("decode"):
            if sensor == "mono":  # reference Examples/Monocular/mono_tum.cc
                frames = [(f.image, f.timestamp) for f in ds]
            else:
                frames = [(f.image, f.depth, f.timestamp) for f in ds]
        gt = None
    elif args.dataset == "kitti":
        from .utils.datasets import KittiOdometryDataset

        ds = KittiOdometryDataset(args.path)
        cp = ds.camera_params
        sensor = "stereo" if args.sensor == "auto" else args.sensor
        with timer("decode"):
            pairs = [ds[i] for i in range(len(ds))]
        h, w = pairs[0].left.shape
        cam = CameraParams.create(fx=cp["fx"], fy=cp["fy"], cx=cp["cx"],
                                  cy=cp["cy"], bf=cp.get("bf", 0.0),
                                  width=w, height=h)
        cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=2000),
                         caps=Capacities(max_keyframes=256, max_points=131072,
                                         local_points=4096),
                         tracking=TrackingConfig(max_frames_between_kf=10),
                         sensor=sensor, vocab=vocab)
        slam = System(cfg, device=device)
        if sensor == "mono":  # reference Examples/Monocular/mono_kitti.cc
            frames = [(p.left, p.timestamp) for p in pairs]
        else:
            frames = [(p.left, p.right, p.timestamp) for p in pairs]
        gt = None
    elif args.dataset == "euroc":
        from .utils.config_io import load_settings
        from .utils.datasets import EurocDataset

        sensor = "stereo" if args.sensor == "auto" else args.sensor
        cfg = load_settings(args.settings, sensor=sensor, vocab=vocab)
        ds = EurocDataset(args.path)
        slam = System(cfg, device=device)
        # EuRoC raw images are unrectified: build the undistort-rectify maps
        # from the settings' LEFT.*/RIGHT.* blocks and remap every pair on
        # the host, like the reference driver (Examples/Stereo/stereo_euroc.cc:45-80).
        rect = None
        if args.settings and sensor == "stereo":
            from .utils.rectify import load_rectification_from_settings

            rect = load_rectification_from_settings(args.settings)
            if rect is None:
                print("warning: no LEFT./RIGHT. rectification blocks in "
                      "settings; using raw images", file=sys.stderr)
        with timer("decode"):
            pairs = [ds[i] for i in range(len(ds))]
            if sensor == "mono":  # reference Examples/Monocular/mono_euroc.cc
                frames = [(p.left, p.timestamp) for p in pairs]
            elif rect is not None:
                frames = [(*rect.rectify(p.left, p.right), p.timestamp) for p in pairs]
            else:
                frames = [(p.left, p.right, p.timestamp) for p in pairs]
        gt = None
    else:
        ap.error("need --synthetic or --dataset")
        return 2

    track = {"rgbd": slam.track_rgbd, "stereo": slam.track_stereo,
             "mono": slam.track_monocular}[sensor]
    with timer("track"):
        if args.batch and sensor == "mono":
            a = np.stack([f[0] for f in frames])
            ts = np.array([f[1] for f in frames])
            for s in range(0, len(frames), args.batch):
                slam.track_batch_mono(a[s:s + args.batch], ts[s:s + args.batch])
        elif args.batch and sensor in ("rgbd", "stereo"):
            a = np.stack([f[0] for f in frames])
            b = np.stack([f[1] for f in frames])
            ts = np.array([f[2] for f in frames])
            track_batch = (slam.track_batch_rgbd if sensor == "rgbd"
                           else slam.track_batch_stereo)
            for s in range(0, len(frames), args.batch):
                track_batch(a[s:s + args.batch], b[s:s + args.batch],
                            ts[s:s + args.batch])
        else:
            for i, f in enumerate(frames):
                track(*f)
                if i % 50 == 0:
                    print(f"frame {i}/{len(frames)} state={slam.state} "
                          f"kf={slam.n_keyframes()}", file=sys.stderr)
    total = timer.samples["track"][-1]
    decode = sum(timer.samples["decode"])

    timings = np.array(slam.timings[5:]) if len(slam.timings) > 5 else np.array([1.0])
    print(f"frames: {len(frames)}  total: {total:.1f}s")
    print(f"median tracking time: {np.median(timings)*1e3:.1f} ms")
    print(f"mean tracking time:   {np.mean(timings)*1e3:.1f} ms")
    print(f"keyframes: {slam.n_keyframes()}  map points: {slam.n_points()}")
    print(f"device: {device}  decode: {decode:.3f}s  tracking: {total:.3f}s  "
          f"state: {slam.state}")

    slam.save_trajectory_tum(args.output)
    print(f"trajectory written: {args.output}")
    if args.kitti_output:
        slam.save_trajectory_kitti(args.kitti_output)

    if gt is not None:
        from .utils.evaluation import ate_rmse, rpe_rmse

        _, est = slam.get_trajectory()
        if len(est) < 3:
            print("trajectory too short for ATE")
            return 0
        if sensor == "mono":
            # mono starts at the two-frame init and is scale-ambiguous:
            # align the tail window with Sim3 (TUM mono evaluation protocol)
            gt_w = gt[len(gt) - len(est):]
            ate = ate_rmse(est, gt_w, with_scale=True)
            rpe_t, rpe_r = rpe_rmse(est, gt_w)
        else:
            n = min(len(est), len(gt))
            ate = ate_rmse(est[:n], gt[:n])
            rpe_t, rpe_r = rpe_rmse(est[:n], gt[:n])
        print(f"ATE RMSE: {ate*100:.2f} cm   RPE: {rpe_t*100:.2f} cm/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
