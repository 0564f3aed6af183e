"""YARP excitation client (requires the `yarp` python bindings and a

The port's copy of flobaroid_tpu/robot_io/yarp_gym.py (host code: plain
Python, numpy and the robot's own bindings).
robot-side control module speaking the same bottle protocol — either
the reference's yarpGYM module or any GYM-style position-direct
controller).

Port of the reference's excitation/robotCommunication/yarp_gym.py:24-155:
stream target angles as Bottle messages over /excitation/command:o,
read (q, qdot, tau, t) state bottles synchronously, use the network
clock, wait for the zero-velocity trajectory phase before starting.
"""

from __future__ import annotations

import numpy as np


def gen_position_msg(port, angles):
    b = port.prepare()
    b.clear()
    b.addString("set_legs_refs")
    for a in angles:
        b.addFloat64(float(a))
    return b


def main(config: dict, trajectory, out: dict):
    try:
        import yarp
    except ImportError as e:
        raise RuntimeError(
            "yarp python bindings are not available; use exciteMethod 'tcp' "
            "with the native excitation_server, or 'ros'"
        ) from e

    yarp.Network.init()
    yarp.Time.useNetworkClock("/clock")
    yarp.Time.now()
    while not yarp.Time.isValid():
        continue

    command_port = yarp.BufferedPortBottle()
    command_port.open("/excitation/command:o")
    yarp.Network.connect("/excitation/command:o", "/excitation/command:i")
    data_port = yarp.BufferedPortBottle()
    data_port.open("/excitation/state:i")
    yarp.Network.connect("/excitation/state:o", "/excitation/state:i")

    nd = int(config["num_dofs"])
    periods = int(getattr(config.get("args"), "periods", 1) or 1)
    duration = periods * trajectory.getPeriodLength()

    measured_q, measured_v, measured_tau, measured_t = [], [], [], []
    sent_q, sent_v, sent_a, sent_t = [], [], [], []

    t_init = yarp.Time.now()
    t_elapsed = 0.0
    started = False
    waited = 0.0
    while t_elapsed < duration + waited:
        trajectory.setTime(t_elapsed)
        angles = [trajectory.getAngle(i) for i in range(nd)]
        if not started:
            started = trajectory.wait_for_zero_vel(t_elapsed)
            t_elapsed = yarp.Time.now() - t_init
            waited = t_elapsed
            if started:
                gen_position_msg(command_port, angles)
                command_port.write()
                yarp.Time.delay(trajectory.getPeriodLength() / 2)
                t_init = yarp.Time.now() - waited
            continue

        gen_position_msg(command_port, angles)
        command_port.write()
        sent_q.append(angles)
        sent_v.append([trajectory.getVelocity(i) for i in range(nd)])
        sent_a.append([trajectory.getAcceleration(i) for i in range(nd)])
        sent_t.append(t_elapsed - waited)

        # synchronous state read (syncs this loop to the control loop)
        b_in = data_port.read(True)
        if b_in is not None:
            lst = [b_in.get(k).asFloat64() for k in range(b_in.size())]
            measured_q.append(lst[:nd])
            measured_v.append(lst[nd : 2 * nd])
            measured_tau.append(lst[2 * nd : 3 * nd])
            measured_t.append(lst[3 * nd] if len(lst) > 3 * nd else t_elapsed - waited)
        t_elapsed = yarp.Time.now() - t_init

    command_port.close()
    data_port.close()

    out["Q"] = np.asarray(measured_q)
    out["V"] = np.asarray(measured_v)
    out["Tau"] = np.asarray(measured_tau)
    out["T"] = np.asarray(measured_t)
    out["Qsent"] = np.asarray(sent_q)
    out["QdotSent"] = np.asarray(sent_v)
    out["QddotSent"] = np.asarray(sent_a)
    dt = np.diff(out["T"])
    out["measured_frequency"] = 1.0 / float(np.mean(dt)) if len(dt) else config["excitationFrequency"]
    return out
