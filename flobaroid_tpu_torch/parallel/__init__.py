"""Sharding over devices in one process (`mesh.py`) and the multi-device
dry run of the production sharded paths (`dryrun.py`)."""
