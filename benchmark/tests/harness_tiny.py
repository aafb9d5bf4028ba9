"""A tiny form of a cell for the CPU: the cell's config cut to 4 frames at
40x40, 64 rays, a 16^3 occupancy grid and one iteration an epoch, and its
SDS prior's "<random-tiny>" widths (the prior's TINY_SPEC); every option
and budget as the cell has them."""
import copy
import dataclasses

from benchmark import inputs

ALL_METRICS = ("idle_share", "peak_mem_gib", "mfu", "real_step.device_ms",
               "sds_step.device_ms", "sds_render.device_ms",
               "level_histogram_roofline")


def tiny(name: str):
    cell = copy.deepcopy(inputs.load_cell(name))
    cfg = inputs.run_config(cell)
    cfg["data"].update(synthetic_frames=4, synthetic_res=40)
    cfg["train"].update(real_ray_num=64, n_iters=1)
    cfg["tpu"].update(occ_resolution=16, march_steps=64,
                      max_samples_per_ray=16)
    if cfg["guidance"]["model"]:
        kind = inputs.prior_kind(cfg)
        spec = dataclasses.asdict(inputs.load_prior(kind).TINY_SPEC)
        spec["compute_dtype"] = "bfloat16"
        cell[f"{kind}_spec"] = spec
    return cell, cfg


def metrics():
    return {"end_to_end": [{"name": "step_ms", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": n, "unit": "-"} for n in ALL_METRICS]}
