"""TCP client for the native excitation server.

The port's copy of flobaroid_tpu/robot_io/tcp_bridge.py (host code: plain
Python, numpy and the robot's own bindings).

Counterpart of the reference's YARP streaming client
(excitation/robotCommunication/yarp_gym.py:24-155) but talking to the
in-repo native/excitation_server C++ module over a plain TCP line
protocol (see excitation_server.cpp): wait for the zero-velocity
trajectory phase, stream position targets at the excitation frequency,
record the (q, dq, tau, t) state stream.
"""

from __future__ import annotations

import socket
import time

import numpy as np


class ExcitationClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 7777, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock_file = self.sock.makefile("r")
        self._send("HELLO")
        reply = self.sock_file.readline().split()
        if not reply or reply[0] != "OK":
            raise RuntimeError(f"unexpected server reply: {reply}")
        self.num_dofs = int(reply[1])
        self.control_rate = float(reply[2])

    def _send(self, line: str):
        self.sock.sendall((line + "\n").encode())

    def set_targets(self, q):
        self._send("T " + " ".join(f"{v:.9g}" for v in q))

    def stream(self, on: bool):
        self._send(f"STREAM {1 if on else 0}")

    def read_state(self):
        line = self.sock_file.readline()
        if not line:
            raise ConnectionError("server closed connection")
        parts = line.split()
        if parts[0] != "S":
            return None
        vals = np.array([float(v) for v in parts[1:]])
        n = self.num_dofs
        return vals[0], vals[1 : 1 + n], vals[1 + n : 1 + 2 * n], vals[1 + 2 * n : 1 + 3 * n]

    def close(self):
        try:
            self._send("QUIT")
        except OSError:
            pass
        self.sock_file.close()
        self.sock.close()


def main(config: dict, trajectory, out: dict):
    """Drive the robot through `trajectory` and record measurements into
    `out` (keys Q/V/Tau/T/Qsent/QdotSent/QddotSent, reference
    yarp_gym.main contract)."""
    host = config.get("tcpHost", "127.0.0.1")
    port = int(config.get("tcpPort", 7777))
    periods = int(config.get("args").periods if config.get("args") else 1) or 1
    nd = int(config["num_dofs"])

    client = ExcitationClient(host, port)
    if client.num_dofs != nd:
        raise RuntimeError(f"server has {client.num_dofs} dofs, model has {nd}")

    duration = periods * trajectory.getPeriodLength()
    freq = float(config["excitationFrequency"])

    measured_q, measured_v, measured_tau, measured_t = [], [], [], []
    sent_q, sent_v, sent_a, sent_t = [], [], [], []

    # settle at the zero-velocity phase of the trajectory first
    # (reference yarp_gym.py:70-90)
    t_elapsed = 0.0
    started = False
    t0 = time.monotonic()
    while not started and t_elapsed < duration:
        started = trajectory.wait_for_zero_vel(t_elapsed)
        t_elapsed = time.monotonic() - t0
    start_offset = t_elapsed
    trajectory.setTime(start_offset)
    client.set_targets([trajectory.getAngle(i) for i in range(nd)])
    time.sleep(0.5)

    client.stream(True)
    t0 = time.monotonic()
    next_cmd = 0.0
    while True:
        t_elapsed = time.monotonic() - t0
        if t_elapsed >= duration:
            break
        if t_elapsed >= next_cmd:
            tt = start_offset + t_elapsed
            trajectory.setTime(tt)
            q_ref = [trajectory.getAngle(i) for i in range(nd)]
            client.set_targets(q_ref)
            sent_q.append(q_ref)
            sent_v.append([trajectory.getVelocity(i) for i in range(nd)])
            sent_a.append([trajectory.getAcceleration(i) for i in range(nd)])
            sent_t.append(t_elapsed)
            next_cmd += 1.0 / freq
        state = client.read_state()
        if state is not None:
            t, q, dq, tau = state
            measured_t.append(t)
            measured_q.append(q)
            measured_v.append(dq)
            measured_tau.append(tau)
    client.stream(False)
    client.close()

    out["Q"] = np.asarray(measured_q)
    out["V"] = np.asarray(measured_v)
    out["Tau"] = np.asarray(measured_tau)
    out["T"] = np.asarray(measured_t)
    out["Qsent"] = np.asarray(sent_q)
    out["QdotSent"] = np.asarray(sent_v)
    out["QddotSent"] = np.asarray(sent_a)
    out["measured_frequency"] = (
        len(measured_t) / (measured_t[-1] - measured_t[0]) if len(measured_t) > 1 else freq
    )
    return out
