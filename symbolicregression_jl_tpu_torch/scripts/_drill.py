"""What the port's drill CLIs share: the ``--device`` flag and its rig check.

Every drill runs its searches on ``--device``: the card by default, the CPU
only when ``--device cpu`` asks for it. A drill that finds no card there is
a rig error (exit 2), never a fall-back to the CPU.
"""

from __future__ import annotations

import argparse
import sys


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the drills' one flag, ``--device``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the drill's searches run: the card (default; no card "
                         "is a rig error, exit 2) or, when asked for, the CPU")
    return ap


def check_device(prog: str, device: str) -> None:
    """Exit 2, a rig error, when ``device`` is the card and there is none."""
    import torch

    if str(device).startswith("cuda") and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (pass --device cpu to run the drill on the CPU)",
              file=sys.stderr, flush=True)
        raise SystemExit(2)

