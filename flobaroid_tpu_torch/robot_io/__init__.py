"""Robot back-ends of `cli.excite`: the native excitation server over TCP,
ROS/MoveIt and YARP."""
