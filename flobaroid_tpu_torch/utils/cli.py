"""Shared CLI plumbing for the port's pipeline commands (trajectory /
simulator / excite / identifier / visualizer), mirroring the
reference's argparse + YAML pattern (reference: identifier.py:1441-1505,
simulator.py:20-80) and flobaroid_tpu/utils/cli.py.

Every command that computes on a device takes `--device` (default
"cuda"): the work runs on the card unless the caller asks for the CPU,
and "cuda" without a card raises with no CPU fallback. excite, which is
host work only, has no `--device`. PyYAML is loaded here, by the
commands only, to read `--config`.
"""

from __future__ import annotations

import argparse

from ..device import resolve_device
from .config import load_config


def base_parser(description: str, prog: str | None = None,
                device: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description, prog=prog)
    p.add_argument("--config", required=True, help="YAML configuration file")
    p.add_argument("-m", "--model", required=True, help="robot URDF model file")
    p.add_argument("--regressor", help="regressor XML with joint name ordering")
    if device:
        p.add_argument("--device", default="cuda",
                       help="torch device of the computation (default: cuda; cpu on request)")
    return p


def setup_device(args):
    """The command's torch.device: `--device` through
    device.resolve_device (precision policy; raises without a card)."""
    return resolve_device(args.device)


def load_cli_config(args) -> dict:
    cfg = load_config(args.config)
    cfg["urdf"] = args.model
    if getattr(args, "regressor", None):
        cfg["regressor"] = args.regressor
    return cfg
