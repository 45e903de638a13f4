"""Map checkpoints of the port: round trip, exchange with the JAX package in
both directions (every MapState field equal, descriptor words as the same
bits), and the refusals: an unknown field, a checkpoint without a schema
version, and one of a newer schema (which the JAX package's loader does not
check; the port's does).
"""

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import checkpoint as jcheckpoint
from self_commit_orb_slam2_tpu.models import map_state as jms
from self_commit_orb_slam2_tpu_torch.models import checkpoint, config
from self_commit_orb_slam2_tpu_torch.models import map_state as ms
from self_commit_orb_slam2_tpu_torch.models.system import STATE_LOST, STATE_NOT_INITIALIZED, System
from self_commit_orb_slam2_tpu_torch.ops import bow
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig

CAPS = config.Capacities(max_keyframes=6, max_points=64, cull_log=8, loop_log=4, bow_top=16)


def _cfg(vocab=None):
    cam = CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0,
                              width=320, height=240)
    return config.SlamConfig(camera=cam, orb=OrbConfig(n_features=40), caps=CAPS, vocab=vocab)


def _tiny_vocab():
    return bow.from_arrays(np.zeros((3, 8), np.uint32), np.array([[1, 2], [-1, -1], [-1, -1]]),
                           np.array([-1, 0, 1]), np.ones(2, np.float32), 2, 1, 2, 0)


def _random_map(rng, vocab=None) -> ms.MapState:
    """A map with every field filled from the seed, in the field's dtype;
    descriptor words cover the sign bit."""
    m = ms.empty_map(_cfg(vocab), "cpu")
    out = {}
    for name, t in m._asdict().items():
        if t.dtype == torch.bool:
            a = rng.random(t.shape) < 0.5
        elif t.dtype == torch.float32:
            a = rng.normal(size=t.shape).astype(np.float32)
        elif name.endswith("desc"):
            a = rng.integers(-2**31, 2**31, t.shape, dtype=np.int64).astype(np.int32)
        elif t.dtype == torch.int8:
            a = rng.integers(0, 2, t.shape).astype(np.int8)
        else:
            a = rng.integers(-1, 50, t.shape).astype(np.int32)
        out[name] = torch.from_numpy(np.asarray(a))
    return ms.MapState(**out)


def _assert_maps_equal(a: ms.MapState, b: ms.MapState):
    for name in ms.MapState._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


@pytest.mark.parametrize("with_vocab", [False, True])
def test_round_trip(with_vocab, rng, tmp_path):
    m = _random_map(rng, _tiny_vocab() if with_vocab else None)
    assert m.kf_bow_ids.shape[1] == (16 if with_vocab else 1)
    path = str(tmp_path / "map.npz")
    checkpoint.save_map(path, m)
    _assert_maps_equal(checkpoint.load_map(path), m)


def test_port_checkpoint_loads_in_jax(rng, tmp_path):
    m = _random_map(rng, _tiny_vocab())
    path = str(tmp_path / "port.npz")
    checkpoint.save_map(path, m)
    jm = jcheckpoint.load_map(path)
    empty = jms.empty_map(_jax_cfg())
    for name in ms.MapState._fields:
        got = np.asarray(getattr(jm, name))
        assert got.dtype == np.asarray(getattr(empty, name)).dtype, name
        want = getattr(m, name).numpy()
        np.testing.assert_array_equal(got, want.view(np.uint32) if name.endswith("desc")
                                      else want, err_msg=name)


def _jax_cfg():
    from self_commit_orb_slam2_tpu.models import config as jconfig
    from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
    from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb

    cam = JCam.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
    return jconfig.SlamConfig(camera=cam, orb=JOrb(n_features=40),
                              caps=jconfig.Capacities(**CAPS._asdict()), vocab=object())


def test_jax_checkpoint_loads_in_port(rng, tmp_path):
    import jax.numpy as jnp

    m = _random_map(rng, _tiny_vocab())
    jm = jms.MapState(**{
        name: jnp.asarray(t.numpy().view(np.uint32) if name.endswith("desc") else t.numpy())
        for name, t in m._asdict().items()})
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_map(path, jm)
    _assert_maps_equal(checkpoint.load_map(path), m)
    # and the file the port writes from it is the file the JAX package wrote
    path2 = str(tmp_path / "port.npz")
    checkpoint.save_map(path2, checkpoint.load_map(path))
    with np.load(path) as a, np.load(path2) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _resave(path, out, drop=(), **extra):
    with np.load(path) as z:
        d = {k: z[k] for k in z.files if k not in drop}
    d.update(extra)
    np.savez_compressed(out, **d)
    return out


def test_refusals_and_defaults(rng, tmp_path):
    m = _random_map(rng)
    path = str(tmp_path / "map.npz")
    checkpoint.save_map(path, m)
    with pytest.raises(ValueError, match="unknown MapState fields"):
        checkpoint.load_map(_resave(path, str(tmp_path / "a.npz"), kf_colour=np.zeros(3)))
    with pytest.raises(ValueError, match="newer"):
        checkpoint.load_map(_resave(path, str(tmp_path / "b.npz"),
                                    __schema_version__=np.int32(checkpoint.SCHEMA_VERSION + 1)))
    with pytest.raises(ValueError, match="schema version"):
        checkpoint.load_map(_resave(path, str(tmp_path / "c.npz"), drop=("__schema_version__",)))
    with pytest.raises(ValueError, match="missing MapState field 'pt_pos'"):
        checkpoint.load_map(_resave(path, str(tmp_path / "d.npz"), drop=("pt_pos",)))
    # fields with a documented default are synthesized, as in the JAX package
    old = checkpoint.load_map(_resave(path, str(tmp_path / "e.npz"),
                                      drop=("pt_birth", "kf_tree_parent_seq"),
                                      __schema_version__=np.int32(1)))
    assert torch.equal(old.pt_birth, torch.zeros(64, dtype=torch.int32))
    assert torch.equal(old.kf_tree_parent_seq, torch.full((6,), -1, dtype=torch.int32))
    assert checkpoint.SCHEMA_VERSION == jcheckpoint.SCHEMA_VERSION
    assert set(checkpoint._FIELD_DEFAULTS) == set(jcheckpoint._FIELD_DEFAULTS)


def test_system_save_and_load_map(rng, tmp_path):
    """System.load_map mirrors the JAX package: the map is restored, the
    state is LOST when it holds keyframes (NOT_INITIALIZED when empty) and
    the carry is not part of a checkpoint."""
    a = System(_cfg(), enable_mapping=False, enable_loop_closing=False, device="cpu")
    a.map = _random_map(rng)._replace(n_kf=torch.tensor(3, dtype=torch.int32))
    path = str(tmp_path / "sys.npz")
    a.save_map(path)
    b = System(_cfg(), enable_mapping=False, enable_loop_closing=False, device="cpu")
    b.load_map(path)
    _assert_maps_equal(b.map, a.map)
    assert b.state == STATE_LOST and b.carry is None
    a.reset()
    a.save_map(path)
    b.load_map(path)
    assert b.state == STATE_NOT_INITIALIZED
