"""The port's viewers (flobaroid_tpu_torch/visualizer.py,
webgl_viewer.py) against the JAX package's, on the CPU.

A two-link robot with an STL cube on each link (tests/test_visualizer.py's
fixture, copied here) and the 7-DOF arm. The link poses of the port's
batched FK against the JAX viewer's per-pose FK: 1e-10 in f64. The
WebGL export of both packages on one trajectory: the decoded f32 pose
buffers within 1e-6, the same metadata (frames, samples, violating
links, joints) and the same torque-utilization buffer.
"""

import base64
import json
import os
import struct

import numpy as np
import pytest
import torch

from flobaroid_tpu import visualizer as jax_visualizer
from flobaroid_tpu import webgl_viewer as jax_webgl
from flobaroid_tpu.collision import CollisionModel as JaxCollisionModel
from flobaroid_tpu.dynamics.engine import DynamicsEngine as JaxEngine
from flobaroid_tpu.models.urdf import load_urdf as jax_load_urdf
from flobaroid_tpu_torch import visualizer, webgl_viewer
from flobaroid_tpu_torch.collision import CollisionModel
from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine
from flobaroid_tpu_torch.models.urdf import load_urdf

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")

URDF = """
<robot name="meshbot">
  <link name="base">
    <inertial><mass value="1.0"/><inertia ixx="0.1" iyy="0.1" izz="0.1"/></inertial>
    <visual><geometry><mesh filename="meshes/cube.stl"/></geometry></visual>
  </link>
  <link name="l1">
    <inertial><mass value="0.5"/><origin xyz="0 0 0.1"/>
      <inertia ixx="0.05" iyy="0.05" izz="0.05"/></inertial>
    <visual><origin xyz="0 0 0.05"/><geometry><mesh filename="meshes/cube.stl"/></geometry></visual>
  </link>
  <joint name="j1" type="revolute">
    <origin xyz="0 0 0.12"/><axis xyz="0 1 0"/><parent link="base"/><child link="l1"/>
    <limit lower="-2" upper="2" effort="10" velocity="3"/>
  </joint>
</robot>
"""
# a wall that the swinging link l1 passes through
WORLD = """
<robot name="room"><link name="wall">
  <inertial><mass value="100"/><inertia ixx="1" iyy="1" izz="1"/></inertial>
  <visual><origin xyz="0.2 0 0.2"/><geometry><box size="0.04 0.4 0.2"/></geometry></visual>
</link></robot>
"""


def _write_cube_stl(path):
    c = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float) * 0.1
    faces = [(0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6), (0, 4, 5), (0, 5, 1),
             (3, 2, 6), (3, 6, 7), (0, 3, 7), (0, 7, 4), (1, 5, 6), (1, 6, 2)]
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(faces)))
        for a, b, cc in faces:
            f.write(struct.pack("<3f", 0, 0, 1))
            for v in (c[a], c[b], c[cc]):
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))


@pytest.fixture(scope="module")
def meshbot(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_viz")
    os.makedirs(d / "meshes")
    _write_cube_stl(str(d / "meshes" / "cube.stl"))
    urdf = str(d / "robot.urdf")
    with open(urdf, "w") as f:
        f.write(URDF)
    with open(d / "world.urdf", "w") as f:
        f.write(WORLD)
    return urdf


def _viewers(urdf, collisions=True, **kw):
    cfg = dict(checkCollisions=1, meshBaseDir="meshes", maxKinematicDistance=0)
    jt, tt = jax_load_urdf(urdf), load_urdf(urdf)
    je, te = JaxEngine(jt), DynamicsEngine(tt)
    world = os.path.join(os.path.dirname(urdf), "world.urdf")
    jcm = JaxCollisionModel(jt, je, cfg, world_tree=jax_load_urdf(world)) if collisions else None
    tcm = CollisionModel(tt, te, cfg, world_tree=load_urdf(world)) if collisions else None
    jv = jax_visualizer.Visualizer(jt, je, collision_model=jcm, urdf_path=urdf, **kw)
    tv = visualizer.Visualizer(tt, te, collision_model=tcm, urdf_path=urdf, device="cpu", **kw)
    return jv, tv


def test_link_world_matches_jax():
    """Poses of the arm, with and without a base rotation and position:
    the port's batched FK against the JAX viewer's, 1e-10."""
    jv, tv = _viewers(ARM_URDF, collisions=False, draw_meshes=False)
    rng = np.random.default_rng(0)
    Q = rng.uniform(-1, 1, (3, 7))
    rpy = rng.uniform(-0.3, 0.3, (3, 3))
    pos = rng.uniform(-1, 1, (3, 3))
    br = visualizer.base_rotations(rpy)
    Rb, pb = tv.link_world_batch(Q, br, pos)
    for k in range(len(Q)):
        for args in ((), (br[k], pos[k])):
            Rj, pj = jv._link_world(Q[k], *args)
            Rt, pt = tv._link_world(Q[k], *args)
            np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-10)
            np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10)
        np.testing.assert_allclose(Rb[k], Rj, rtol=0, atol=1e-10)
        np.testing.assert_allclose(pb[k], pj, rtol=0, atol=1e-10)


def test_snapshot_and_animation(meshbot, tmp_path):
    """snapshot writes a PNG, animate an HTML scrubber with one frame per
    step (with torque bars)."""
    _, tv = _viewers(meshbot, tau_limits=np.array([10.0]))
    assert set(tv.link_meshes) == {0, 1}
    out = tv.snapshot(np.array([0.5]), str(tmp_path / "pose.png"))
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    Q = np.linspace(-0.5, 0.5, 12)[:, None]
    html = tv.animate(Q, str(tmp_path / "traj.html"), step=4,
                      torques=np.linspace(-12, 12, 12)[:, None])
    content = open(html).read()
    assert content.count("iVBOR") == 3  # three base64 PNG frames
    assert "const frames=[" in content


def _decode(html):
    meta = json.loads(html.split("const META=", 1)[1].split(";\n", 1)[0])

    def buf(name):
        b64 = html.split(f'const {name}=f32("', 1)[1].split('"', 1)[0]
        return np.frombuffer(base64.b64decode(b64), np.float32)

    utils = html.split('const UTILS_B="', 1)[1].split('"', 1)[0]
    return meta, buf("XF"), np.frombuffer(base64.b64decode(utils), np.float32)


@pytest.mark.parametrize("with_base", [False, True], ids=["fixed", "base_pose"])
def test_webgl_export_matches_jax(meshbot, tmp_path, with_base):
    """The two packages' WebGL files on one trajectory that crosses the
    torque limit and sweeps a link through a wall: the pose buffers
    within 1e-6 (f32), the same metadata and utilization bars."""
    jv, tv = _viewers(meshbot, tau_limits=np.array([10.0]))
    N = 30
    Q = np.linspace(-2.0, 2.0, N)[:, None]
    tau = np.linspace(-12, 12, N)[:, None]
    kw = {}
    if with_base:
        rng = np.random.default_rng(1)
        kw = dict(base_rpy=rng.uniform(-0.1, 0.1, (N, 3)), base_pos=rng.uniform(-0.02, 0.02, (N, 3)))
    out = {}
    for name, mod, viz in (("jax", jax_webgl, jv), ("port", webgl_viewer, tv)):
        path = mod.export_webgl(viz, Q, str(tmp_path / f"{name}.html"), step=5, torques=tau, **kw)
        out[name] = _decode(open(path).read())
    (mj, xj, uj), (mp, xp, up) = out["jax"], out["port"]
    assert mp == mj
    assert mp["frames"] == 6 and any(mp["viol"])
    assert xp.shape == xj.shape == (6 * mp["num_links"] * 12,)
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(up, uj)
