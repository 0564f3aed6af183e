"""ROS/MoveIt excitation client (requires rospy + moveit_commander).

The port's copy of flobaroid_tpu/robot_io/ros_moveit.py (host code: plain
Python, numpy and the robot's own bindings).

Port of the reference's excitation/robotCommunication/ros_moveit.py:39-122:
build a complete JointTrajectory plan at the excitation frequency from
the trajectory object, execute via MoveGroupCommander, record
joint_states in a subscriber, resample to the sent sample count.
"""

from __future__ import annotations

import numpy as np


def main(config: dict, trajectory, out: dict):
    try:
        import moveit_commander
        import rospy
        from moveit_msgs.msg import RobotTrajectory
        from sensor_msgs.msg import JointState
        from trajectory_msgs.msg import JointTrajectoryPoint
    except ImportError as e:
        raise RuntimeError(
            "rospy / moveit_commander are not available; use exciteMethod "
            "'tcp' with the native excitation_server, or 'yarp'"
        ) from e

    rospy.init_node("flobaroid_excitation", anonymous=True)
    group_name = config.get("ros_move_group", "")
    group = moveit_commander.MoveGroupCommander(group_name)
    nd = int(config["num_dofs"])
    freq = float(config.get("rosPlanFrequency", 200.0))

    duration = trajectory.getPeriodLength()
    n = int(duration * freq)
    plan = RobotTrajectory()
    plan.joint_trajectory.joint_names = group.get_active_joints()[:nd]

    sent_q, sent_v, sent_a, sent_t = [], [], [], []
    for k in range(n):
        t = k / freq
        trajectory.setTime(t)
        pt = JointTrajectoryPoint()
        pt.positions = [trajectory.getAngle(i) for i in range(nd)]
        pt.velocities = [trajectory.getVelocity(i) for i in range(nd)]
        pt.accelerations = [trajectory.getAcceleration(i) for i in range(nd)]
        pt.time_from_start = rospy.Duration.from_sec(t)
        plan.joint_trajectory.points.append(pt)
        sent_q.append(pt.positions)
        sent_v.append(pt.velocities)
        sent_a.append(pt.accelerations)
        sent_t.append(t)

    measured = {"q": [], "v": [], "tau": [], "t": []}

    def cb(msg: "JointState"):
        measured["q"].append(list(msg.position[:nd]))
        measured["v"].append(list(msg.velocity[:nd]) if msg.velocity else [0.0] * nd)
        measured["tau"].append(list(msg.effort[:nd]) if msg.effort else [0.0] * nd)
        measured["t"].append(msg.header.stamp.to_sec())

    sub = rospy.Subscriber("joint_states", JointState, cb)
    # move to start, then execute the full plan
    group.go(plan.joint_trajectory.points[0].positions, wait=True)
    measured["q"].clear(); measured["v"].clear(); measured["tau"].clear(); measured["t"].clear()
    group.execute(plan, wait=True)
    sub.unregister()

    def resample(arr, n_target):
        arr = np.asarray(arr)
        if len(arr) == 0:
            return np.zeros((n_target, nd))
        idx = np.linspace(0, len(arr) - 1, n_target).astype(int)
        return arr[idx]

    out["Q"] = resample(measured["q"], n)
    out["V"] = resample(measured["v"], n)
    out["Tau"] = resample(measured["tau"], n)
    tm = np.asarray(measured["t"])
    out["T"] = np.asarray(sent_t) if len(tm) == 0 else resample(tm - tm[0], n).reshape(-1)
    out["Qsent"] = np.asarray(sent_q)
    out["QdotSent"] = np.asarray(sent_v)
    out["QddotSent"] = np.asarray(sent_a)
    out["measured_frequency"] = freq
    return out
