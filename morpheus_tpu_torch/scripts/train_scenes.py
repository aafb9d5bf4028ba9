#!/usr/bin/env python
"""Multi-scene fan-out of the port (the port's copy of
scripts/train_scenes.py): per-scene optimization is embarrassingly
parallel, so N scenes are N independent `python -m morpheus_tpu_torch`
processes, one per card.

    python morpheus_tpu_torch/scripts/train_scenes.py configs/snoopy.yaml ...
    python morpheus_tpu_torch/scripts/train_scenes.py --parallel 2 configs/*.yaml
    python morpheus_tpu_torch/scripts/train_scenes.py cfg.yaml --extra --device cpu

Exits 1 if any trainer fails.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("configs", nargs="+")
    parser.add_argument("--parallel", type=int, default=1,
                        help="concurrent trainer processes (one per device)")
    parser.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                        help="extra CLI args forwarded to the trainer")
    args = parser.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    pending = list(args.configs)
    running: list[subprocess.Popen] = []
    failures = 0
    while pending or running:
        while pending and len(running) < args.parallel:
            cfg = pending.pop(0)
            print(f"[launch] {cfg}", flush=True)
            running.append(subprocess.Popen(
                [sys.executable, "-m", "morpheus_tpu_torch", "--config", cfg]
                + args.extra, env=env))
        done = [p for p in running if p.poll() is not None]
        for p in done:
            running.remove(p)
            if p.returncode != 0:
                failures += 1
                print(f"[fail] exit {p.returncode}", flush=True)
        if running:
            running[0].wait()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
