"""Online streaming driver: track frames arriving over a byte stream.

The port's version of the JAX package's stream_slam.py: the same wire
format, record for record, and the same options plus --device (the engine
runs on the card unless --device cpu is given).

Counterpart of the reference's ROS nodes (Examples/ROS/ORB_SLAM2/src/
ros_{mono,stereo,rgbd}.cc) — those are input transport only (image topics ->
TrackX calls, approximate-time stereo sync); here the transport is a simple
length-delimited binary protocol over any file-like byte stream (stdin, a
TCP socket, a FIFO), so a live camera process can feed the tracker without
ROS.

Wire format, little-endian, one record per frame:

    magic    4s   b"SLFR"
    sensor   u8   0=mono 1=stereo 2=rgbd
    height   u16
    width    u16
    ts       f64  seconds
    payload:
      mono:   H*W u8 gray
      stereo: H*W u8 left, H*W u8 right
      rgbd:   H*W u8 gray, H*W u16 depth (millimeters)

Each tracked pose is written back (if an output stream is given) as:

    magic  4s  b"SLPO"
    ts     f64
    state  u8  (1 = OK, 2 = LOST)
    Tcw    16*f32 row-major
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional

import numpy as np

_HDR = struct.Struct("<4sBHHd")
_POSE = struct.Struct("<4sdB16f")

SENSOR_CODE = {"mono": 0, "stereo": 1, "rgbd": 2}
SENSOR_NAME = {v: k for k, v in SENSOR_CODE.items()}


def write_frame(out: BinaryIO, sensor: str, ts: float, *arrays) -> None:
    """Serialize one frame record (sender side / test utility)."""
    h, w = arrays[0].shape
    out.write(_HDR.pack(b"SLFR", SENSOR_CODE[sensor], h, w, ts))
    if sensor == "mono":
        out.write(np.clip(arrays[0], 0, 255).astype(np.uint8).tobytes())
    elif sensor == "stereo":
        out.write(np.clip(arrays[0], 0, 255).astype(np.uint8).tobytes())
        out.write(np.clip(arrays[1], 0, 255).astype(np.uint8).tobytes())
    else:
        out.write(np.clip(arrays[0], 0, 255).astype(np.uint8).tobytes())
        mm = np.clip(np.asarray(arrays[1]) * 1e3, 0, 65535).astype("<u2")
        out.write(mm.tobytes())


def _read_exact(inp: BinaryIO, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = inp.read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame(inp: BinaryIO):
    """Returns (sensor, ts, arrays) or None at end of stream."""
    hdr = _read_exact(inp, _HDR.size)
    if hdr is None:
        return None
    magic, code, h, w, ts = _HDR.unpack(hdr)
    if magic != b"SLFR":
        raise ValueError(f"bad frame magic {magic!r}")
    sensor = SENSOR_NAME[code]
    gray = _read_exact(inp, h * w)
    if gray is None:
        return None
    img = np.frombuffer(gray, np.uint8).reshape(h, w).astype(np.float32)
    if sensor == "mono":
        return sensor, ts, (img,)
    second = _read_exact(inp, h * w * (2 if sensor == "rgbd" else 1))
    if second is None:
        return None
    if sensor == "stereo":
        right = np.frombuffer(second, np.uint8).reshape(h, w).astype(np.float32)
        return sensor, ts, (img, right)
    depth = np.frombuffer(second, "<u2").reshape(h, w).astype(np.float32) * 1e-3
    return sensor, ts, (img, depth)


def write_pose(out: BinaryIO, ts: float, state: int, Tcw: np.ndarray) -> None:
    out.write(_POSE.pack(b"SLPO", ts, state,
                         *np.asarray(Tcw, np.float32).reshape(16)))
    out.flush()


def read_pose(inp: BinaryIO):
    buf = _read_exact(inp, _POSE.size)
    if buf is None:
        return None
    vals = _POSE.unpack(buf)
    if vals[0] != b"SLPO":
        raise ValueError("bad pose magic")
    return vals[1], vals[2], np.array(vals[3:], np.float32).reshape(4, 4)


def serve(slam, inp: BinaryIO, out: Optional[BinaryIO] = None,
          max_frames: Optional[int] = None, rectifier=None) -> int:
    """Track frames from `inp` until end of stream; returns #frames tracked.

    `rectifier`: optional utils.rectify.StereoRectifier applied to stereo
    pairs before tracking (reference ros_stereo.cc do_rectify mode)."""
    n = 0
    track = {"mono": slam.track_monocular, "stereo": slam.track_stereo,
             "rgbd": slam.track_rgbd}
    while max_frames is None or n < max_frames:
        rec = read_frame(inp)
        if rec is None:
            break
        sensor, ts, arrays = rec
        if rectifier is not None and sensor == "stereo":
            arrays = rectifier.rectify(*arrays)
        Tcw = track[sensor](*arrays, ts)
        if out is not None:
            write_pose(out, ts, int(slam.state), Tcw)
        n += 1
    return n


def main(argv=None):
    import argparse
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--settings", default=None, help="reference-style YAML")
    ap.add_argument("--sensor", choices=["mono", "stereo", "rgbd"],
                    default="rgbd")
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--listen", type=int, default=0,
                    help="TCP port to accept one sender on (default: stdin)")
    ap.add_argument("--poses", action="store_true",
                    help="write pose records to stdout / the socket")
    ap.add_argument("--output", default=None, help="TUM trajectory at exit")
    ap.add_argument("--rectify", action="store_true",
                    help="undistort-rectify stereo pairs from the settings' "
                    "LEFT./RIGHT. blocks (reference ros_stereo.cc do_rectify)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda; cpu on purpose)")
    args = ap.parse_args(argv)

    from .models.system import System
    from .ops import bow
    from .utils.config_io import load_settings

    vocab = None
    vpath = args.vocab or bow.default_vocab_path()
    if vpath:
        vocab = bow.load_vocabulary(vpath)
    # the wire carries depth in millimetres, read as metres: the settings'
    # DepthMapFactor describes PNG files, not the stream (the JAX driver
    # applies it to the stream's metres as well, a fault not reproduced here)
    cfg = load_settings(args.settings, sensor=args.sensor, vocab=vocab)._replace(
        depth_map_factor=1.0)
    slam = System(cfg, device=args.device)
    rectifier = None
    if args.rectify and args.settings:
        from .utils.rectify import load_rectification_from_settings

        rectifier = load_rectification_from_settings(args.settings)

    if args.listen:
        import socket

        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", args.listen))
        srv.listen(1)
        conn, _ = srv.accept()
        inp = conn.makefile("rb")
        out = conn.makefile("wb") if args.poses else None
    else:
        inp = sys.stdin.buffer
        out = sys.stdout.buffer if args.poses else None

    n = serve(slam, inp, out, rectifier=rectifier)
    print(f"tracked {n} frames, {slam.n_keyframes()} keyframes", file=sys.stderr)
    if args.output:
        slam.save_trajectory_tum(args.output)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
