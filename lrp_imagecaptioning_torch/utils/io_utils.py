"""Small IO helpers (reference: models/io_utils.py:26-55); the port's own
copy of the JAX package's ``utils/io_utils.py``. yaml is imported inside
``write_yaml_file`` only."""

from __future__ import annotations

import datetime
import os


def mkdir_p(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def read_text_file(path: str) -> list[str]:
    with open(path, "r") as f:
        return [line.rstrip("\n") for line in f]


def write_yaml_file(obj, path: str) -> None:
    import yaml

    mkdir_p(os.path.dirname(path) or ".")
    with open(path, "w") as f:
        yaml.safe_dump(obj, f, default_flow_style=False)


def logging_ts(msg: str) -> None:
    """Timestamped stdout log, like io_utils.logging (io_utils.py:52-55)."""
    print(f"[{datetime.datetime.now().isoformat(timespec='seconds')}] {msg}", flush=True)
