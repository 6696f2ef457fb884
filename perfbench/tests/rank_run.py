"""One rank of a rehearsed several-card run with a fault planted:
``python rank_run.py <fault|none> <run.py arguments>``."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from faults import FAULTS  # noqa: E402

from perfbench import run  # noqa: E402

if __name__ == "__main__":
    if sys.argv[1] != "none":
        FAULTS[sys.argv[1]]()
    sys.exit(run.main(sys.argv[2:]))
