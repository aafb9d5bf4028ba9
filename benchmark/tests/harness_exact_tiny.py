"""The tiny form of snoopy_exact.e700 (harness_tiny.tiny) and the knobs that
make MorpheuS as published of the TPU build's approximations.

harness_tiny's 64-step march stops short of the synthetic sphere, so no
rung of the band ladder would lie in the band and the term would add
nothing: the tiny cell keeps the configuration's march_steps and
max_samples_per_ray."""
import os

from benchmark import inputs
from benchmark.tests.harness_tiny import tiny

CELL = "snoopy_exact.e700"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def exact_tiny():
    cell, cfg = tiny(CELL)
    whole = inputs.run_config(cell)["tpu"]
    for k in ("march_steps", "max_samples_per_ray"):
        cfg["tpu"][k] = whole[k]
    return cell, cfg


def exact_knobs() -> dict:
    """The tpu knobs in which configs/ab_exact.yaml differs from
    configs/ab_shipped.yaml (every sample, the full band ladder, every
    smoothness site, f32 cotangents, the trilinear occupancy EMA)."""
    from morpheus_tpu_torch.config import load_config
    exact, shipped = (load_config(os.path.join(
        ROOT, "configs", f"ab_{arm}.yaml"))["tpu"]
        for arm in ("exact", "shipped"))
    return {k: v for k, v in exact.items() if shipped.get(k) != v}
