"""The card the run uses."""

from __future__ import annotations

import subprocess


def name_and_power_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable: {exc!r}"
