"""The port's robot back-ends (flobaroid_tpu_torch/robot_io), its excite
command and the GUI's command lines, against the JAX package's.

The native excitation server (native/excitation_server) is compiled
with g++ into a temporary directory and serves a 3-DOF loopback robot
on a free local port. The port's excite command and the root excite.py
drive it with one trajectory file: they must save the same keys, each
with the same dtype and the same shape apart from the sample count (the
number of recorded samples follows the wall clock).
"""

import contextlib
import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

import excite as jax_excite
from flobaroid_tpu.robot_io import ros_moveit as jax_ros
from flobaroid_tpu.robot_io import yarp_gym as jax_yarp
from flobaroid_tpu_torch.cli import excite, gui
from flobaroid_tpu_torch.excitation.trajectory import ArrayTrajectory
from flobaroid_tpu_torch.robot_io import ros_moveit, tcp_bridge, yarp_gym

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "native", "excitation_server", "excitation_server.cpp")
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_native")
    binpath = str(d / "excitation_server")
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-pthread", SRC, "-o", binpath],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    port = _free_port()
    proc = subprocess.Popen([binpath, "--dofs", "3", "--port", str(port), "--rate", "500"])
    for _ in range(50):  # until it accepts connections
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            break
        except OSError:
            time.sleep(0.1)
    yield port
    proc.terminate()
    proc.wait(timeout=5)


def test_tcp_client_loopback(server):
    """The port's client: handshake, targets, the state stream."""
    c = tcp_bridge.ExcitationClient(port=server)
    assert (c.num_dofs, c.control_rate) == (3, 500.0)
    c.stream(True)
    target = [0.3, -0.2, 0.1]
    c.set_targets(target)
    states = []
    t_end = time.monotonic() + 1.0
    while time.monotonic() < t_end:
        s = c.read_state()
        if s is not None:
            states.append(s)
    c.stream(False)
    c.close()
    assert len(states) > 50
    np.testing.assert_allclose(states[-1][1], target, atol=0.05)
    ts = [s[0] for s in states]
    assert all(b >= a for a, b in zip(ts, ts[1:]))


@pytest.fixture(scope="module")
def three_dof(tmp_path_factory):
    """The arm cut after its third link, a 1.5 s trajectory file and an
    excite configuration for the loopback server."""
    d = tmp_path_factory.mktemp("torch_excite")
    with open(ARM_URDF) as f:
        txt = f.read()
    urdf = d / "three.urdf"
    urdf.write_text(txt[:txt.index('<joint name="arm_3_joint"')] + "</robot>\n")
    n = 75
    tms = np.arange(n) / 50.0
    Q = 0.25 * np.sin(2 * np.pi * 0.4 * tms)[:, None] * np.ones((1, 3))
    V = 0.25 * 2 * np.pi * 0.4 * np.cos(2 * np.pi * 0.4 * tms)[:, None] * np.ones((1, 3))
    traj = d / "traj.npz"
    np.savez(traj, static=False, positions=Q, velocities=V, accelerations=np.zeros_like(Q),
             times=tms, frequency=np.float64(50.0))
    return dict(dir=d, urdf=str(urdf), traj=str(traj))


def _config(three_dof, port, **extra):
    cfg = dict(excitationFrequency=50.0, exciteMethod="tcp", tcpPort=port, floatingBase=0,
               verbose=0, filterMedianSize=5, filterLowPass1=[8.0, 4], filterLowPass2=[6.0, 4],
               filterLowPass3=[3.0, 3], **extra)
    path = os.path.join(three_dof["dir"], f"cfg_{port}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_excite_command_saves_the_root_keys(server, three_dof):
    """cli.excite (exciteMethod tcp, host work only) and the root excite.py
    on one trajectory file: the same keys, dtypes and shapes apart from
    the sample count."""
    cfg = _config(three_dof, server)
    common = ["--config", cfg, "--model", three_dof["urdf"], "--trajectory", three_dof["traj"]]
    files = {k: os.path.join(three_dof["dir"], f"meas_{k}.npz") for k in ("port", "jax")}
    with contextlib.redirect_stdout(io.StringIO()):
        excite.main([*common, "--filename", files["port"]])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", ["excite.py", *common, "--filename", files["jax"]])
            jax_excite.main()
    with np.load(files["port"], allow_pickle=True) as fp, \
            np.load(files["jax"], allow_pickle=True) as fj:
        assert set(fp.files) == set(fj.files)
        for k in fj.files:
            assert fp[k].dtype.kind == fj[k].dtype.kind, k
            assert fp[k].ndim == fj[k].ndim and fp[k].shape[1:] == fj[k].shape[1:], k
        assert fp["positions"].shape[1] == 3 and fp["positions"].shape[0] > 50
        assert np.all(np.isfinite(fp["velocities"]))


@pytest.mark.parametrize("static", [False, True], ids=["array", "static_postures"])
def test_excite_dryrun(three_dof, tmp_path, static, capsys):
    """--dryrun loads the trajectory (sampled, or static postures) and
    stops before any robot I/O: no file is written."""
    traj = three_dof["traj"]
    if static:
        traj = str(tmp_path / "static.npz")
        np.savez(traj, static=True, angles=np.array([np.zeros(3), np.full(3, 0.2)], dtype=object))
    out = str(tmp_path / "meas.npz")
    excite.main(["--config", _config(three_dof, 0), "--model", three_dof["urdf"],
                 "--trajectory", traj, "--filename", out, "--dryrun"])
    text = capsys.readouterr().out
    assert "dryrun: trajectory loaded OK" in text
    assert ("static postures" in text) == static
    assert not os.path.exists(out)


@pytest.mark.parametrize("backend", ["ros", "yarp"])
def test_ros_yarp_raise_the_jax_error(backend):
    """Without rospy / yarp both packages raise the same error, naming the
    other back-ends."""
    mods = dict(ros=(ros_moveit, jax_ros), yarp=(yarp_gym, jax_yarp))[backend]
    traj = ArrayTrajectory(np.arange(3) / 50.0, np.zeros((3, 3)), np.zeros((3, 3)), np.zeros((3, 3)))
    errors = []
    for mod in mods:
        with pytest.raises(RuntimeError) as e:
            mod.main(dict(num_dofs=3, excitationFrequency=50.0), traj, {})
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "tcp" in errors[0]


def test_gui_stage_command_lines():
    """The GUI's stages run the port's commands as `python -m`, with the
    Device field as --device (left out when empty) and the optional
    fields only when set; no display is needed to build them."""
    fields = dict(config="c.yaml", model="r.urdf", world="", model_real="real.urdf",
                  validation="", trajectory="t.npz", measurements="m.npz",
                  model_output="out.urdf", device="cpu")
    head = ["py", "-m"]
    common = ["--config", "c.yaml", "--model", "r.urdf", "--device", "cpu"]
    assert gui.stage_argv("trajectory", fields, python="py") == [
        *head, "flobaroid_tpu_torch.cli.trajectory", *common, "--filename", "t.npz",
        "--model_real", "real.urdf"]
    assert gui.stage_argv("simulator", fields, python="py") == [
        *head, "flobaroid_tpu_torch.cli.simulator", *common, "--trajectory", "t.npz",
        "--filename", "m.npz"]
    assert gui.stage_argv("identifier", fields, python="py") == [
        *head, "flobaroid_tpu_torch.cli.identifier", *common, "--measurements", "m.npz",
        "--trajectory", "t.npz", "--model_output", "out.urdf", "--model_real", "real.urdf"]
    assert gui.stage_argv("visualizer", dict(fields, device="", world="w.urdf"), python="py") == [
        *head, "flobaroid_tpu_torch.cli.visualizer", "--config", "c.yaml", "--model", "r.urdf",
        "--trajectory", "m.npz", "--webgl", "--world", "w.urdf"]
    assert "device" in dict(gui.PipelineGUI.FIELDS)
    with pytest.raises(ValueError):
        gui.stage_argv("excite", fields)
