"""Robot descriptions of the reference, one module a robot, found by the name
a configuration's ``reference.robot`` gives: each has ``spec(**args)``
returning a spec.RobotSpec (``args`` from ``reference.robot_args``)."""
