#!/usr/bin/env python
"""Ablation profiler of the Zero123 SDS virtual step (the port of
scripts/profile_sds.py): the regime that owns most of a full run's
wall-clock (novel_view_scale 0.5 past epoch 800: 32,400 rendered rays a
virtual step, configs/snoopy.yaml). bench.py times one total per operating
point; this splits the step's cost by knob:

  s05            float32 UNet, epoch 300 (the bench's anchor)
  s05_noremat    tpu.remat_virtual off: the price of recomputing the
                 virtual render and the VAE encoder in the backward
  s05_bf16       bf16 UNet (the reference's fp16 autocast analogue)
  s05_bf16_late  + all 16 hash levels (epoch 1900, the run's post-800 point)
  s05_bf16_late_noremat  the above without recomputation
  s02            the 5,184-ray point (before epoch 800)
  s05_bf16_late_mlpbf16  + tpu.mlp_dtype bfloat16 (the field's MLPs)
  s05_bf16_late_mlpbf16_noremat  the above without recomputation

    python -m morpheus_tpu_torch.scripts.profile_sds [variant ...]

Each variant: bench.BENCH_POINT_CFG on an 8-frame 360^2 synthetic scene,
a full-size random-weight Zero123 (~3.4 GB float32, the UNet ~1.7 GB in
bf16), 3 warm-up virtual steps, then 8 timed, one synchronize at the end
(bench.sds_step). Two or more variants run one process each, so that no
variant's memory stays on the card for the next; the script exits 1 if
any of them failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

from morpheus_tpu_torch import bench

VARIANTS = {
    "s05": dict(scale=0.5),
    "s05_noremat": dict(scale=0.5, remat=False),
    "s05_bf16": dict(scale=0.5, bf16=True),
    "s05_bf16_late": dict(scale=0.5, bf16=True, ep=1900),
    "s05_bf16_late_noremat": dict(scale=0.5, bf16=True, ep=1900, remat=False),
    "s02": dict(scale=0.2),
    "s05_bf16_late_mlpbf16": dict(scale=0.5, bf16=True, ep=1900,
                                  mlp_bf16=True),
    "s05_bf16_late_mlpbf16_noremat": dict(scale=0.5, bf16=True, ep=1900,
                                          mlp_bf16=True, remat=False),
}


def time_sds_variant(name: str, scale: float = 0.5, bf16: bool = False,
                     ep: int = bench.BENCH_EPOCH, remat: bool = True,
                     mlp_bf16: bool = False, device="cuda", frames: int = 8,
                     hw: int = 360, spec=None, base: dict | None = None,
                     warmup: int = 3, n: int = 8, log=bench.log) -> float:
    """Seconds an SDS step of one variant (module doc); prints its line.
    spec: the guidance architecture (default: the full-size Zero123Spec)."""
    from morpheus_tpu_torch.guidance.zero123 import Zero123Spec
    cfg = bench.bench_config({"tpu": {
        "remat_virtual": remat,
        **({"mlp_dtype": "bfloat16"} if mlp_bf16 else {})}}, base)
    gspec = Zero123Spec() if spec is None else spec
    if bf16:
        gspec = dataclasses.replace(gspec, compute_dtype="bfloat16")
    res = bench.sds_step(cfg, bench.make_dataset(cfg, frames, hw), gspec,
                         scale, ep, device, warmup, n)
    dt = res["ms"] / 1e3
    log(f"{name:30s} {res['ms']:8.1f} ms/step  {res['rays'] / dt:9.0f} "
        f"rays/s  (warm-up {res['warm_s']:.1f}s, loss {res['loss']:.4f})")
    return dt


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*",
                        help=f"of {list(VARIANTS)} (default: all)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    names = args.variants or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}; have {list(VARIANTS)}")
    if len(names) > 1:
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            bench.__file__)))
        failed = [n for n in names if subprocess.run(
            [sys.executable, "-m", "morpheus_tpu_torch.scripts.profile_sds",
             n, "--device", args.device], cwd=root).returncode != 0]
        if failed:
            print(f"profile_sds: variants failed: {failed}", flush=True)
            return 1
        return 0
    from morpheus_tpu_torch.utils import resolve_device
    time_sds_variant(names[0], **VARIANTS[names[0]],
                     device=resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
