"""Config system: per-scene YAML with the reference's six sections plus the
``tpu`` section, and per-section CLI overrides.

The port's own copy of morpheus_tpu/config.py (same keys, same defaults), so
that the two packages read the same YAML files identically. The ``tpu``
section keeps its name: most of its keys are semantic (sample budgets, march
steps, occupancy cadence, gradient payload type), ``remat_virtual``
becomes torch.utils.checkpoint of the virtual render and the VAE encoder,
``chain_steps`` runs the epoch loop's real steps as replays of a CUDA graph
of the step on a card (train/trainer.py), and ``donate_state``, which only
steered XLA's buffer donation, is accepted and ignored by the port.
"""
from __future__ import annotations

import argparse
import copy
import os
from typing import Any

import yaml

DEFAULTS: dict[str, dict[str, Any]] = {
    "data": {
        "data_dir": "",
        "depth_scale": 1000.0,
        "known_view_scale": 1.0,
        "novel_view_scale": 0.2,
        "novel_view_scale_final": 0.5,
        "novel_view_scale_factor": 1.0,
        "theta_range": [45, 105],
        "phi_range": [-180, 180],
        "full_theta_range": [45, 105],
        "full_phi_range": [-180, 180],
        "angle_overhead": 30,
        "angle_front": 60,
        "default_polar": 90.0,
        "default_azimuth": 0.0,
        "uniform_sphere_rate": 0.0,
        "outlier_remove": False,
        # <synthetic> scene generator knobs
        "synthetic_frames": 8,
        "synthetic_res": 64,
    },
    "exp": {
        "output": "./exp",
        "exp_name": "scene",
        "log": "log.txt",
        "fp16": False,
        "save_guidance": True,
        "save_guide_intervel": 50,
        "test_interval": 200,
        "mesh_interval": 50,
        "mesh_all_interval": 400,
        "mesh_all_eval_interval": 400,
        "seed": 2024,
        "clip_ckpt": "",
        "ckpt": "latest",
        "ckpt_interval": 0,
    },
    "render": {
        "step_size": 0.01,
    },
    "train": {
        "kf_every": 2,
        "trunc": 0.1,
        "optim": "adam",
        "lr": 0.0005,
        "ema_decay": 0.95,
        "n_epochs": 2000,
        "n_iters": 10,
        "real_freq": 10,
        "virtual_freq": 1,
        "warm_up_steps": 100,
        "warm_up_end": 200,
        "albedo_iter_ratio": 0.1,
        "min_ambient_ratio": 0.1,
        "textureless_ratio": 0.2,
        "freeze_epoch": 400,
        "progressive_view": False,
        "progressive_view_init_ratio": 0.2,
        "progressive_level": True,
        "real_view_noise": 0.0,
        "real_ray_num": 2048,
        "rgb_weight": 5.0,
        "mask_weight": 0.5,
        "depth_weight": 0.1,
        "sdf_weight": 10.0,
        "surf_sdf_weight": 10,
        "surf_color_weight": 5.0,
        "fs_weight": 0.0,
        "normal_smoothness": 0.4,
        "normal_smooth_3d": 0.1,
        "normal_smooth_3d_t": 0.0,
        "normal_smooth_2d": 0.0,
        "eik_weight": 0.0,
        "normal_dir": False,
        "smoothness_std": 0.005,
        "topo_none": True,
        "code_reg": 0.5,
        "sdf_reg": 0.0,
        "beta_weight": 0.1,
        "ori_weight": 0.01,
        "entropy_weight": 0.0,
        "deform_weight": 0.0,
        "deform_smooth": 0.0,
        "deform_smooth_t": 0.0,
        "topo_smooth_t": 0.0,
    },
    "model": {
        "deform_dim": 16,
        "amb_dim": 2,
        "use_t": False,
        "use_app": False,
        "use_joint": True,
        "color_grid": True,
        "encode_topo": False,
        "bg_radius": 1.4,
    },
    "guidance": {
        "model": ["zero123"],
        "zero123_config": "",
        "zero123_ckpt": "",
        "t_range": [0.02, 0.5],
        "zero123_guidance_scale": 5.0,
        "zero123_train": "cur_or_one",
        "zero123_grad_weight": 0.01,
        "image_size": 256,
        "compute_dtype": "float32",
    },
    "tpu": {
        "max_samples_per_ray": 64,   # K: post-compaction samples per ray
        "march_steps": 288,          # M: candidate steps per ray
        "band_budget": 0,            # surface-band sites per ray (0 = all)
        "smooth_budget": 0,          # perturbed-normal sites per ray (0 = all)
        "sample_budget": 0,          # average field samples per ray after
                                     # global compaction (0 = off)
        "occ_resolution": 128,       # occupancy grid resolution
        "occ_update_every": 16,      # EMA update cadence in steps
        "occ_warmup_steps": 256,     # full-grid updates before this step
        "occ_sample_fraction": 0.25, # cells refreshed per post-warmup update
        "budget_uniform_mix": 0.0,   # uniform score mix for compaction
        "occ_ema_decay": 0.95,
        "occ_threshold": 0.01,
        "occ_query_interp": "nearest",  # hash interpolation of occupancy
                                     # density queries ('nearest' | 'linear')
        "compute_dtype": "float32",  # 'bfloat16': bf16 hash tables and
                                     # MLP products, f32 sums and weights
        "mlp_dtype": "float32",      # 'bfloat16': the MLP half alone
        "grad_payload": "float32",   # hash-grid cotangent payload type
                                     # ('float32' | 'bfloat16', f32 sums)
        "vjp_mode": "hist_rows",     # hash-grid embedding-cotangent route
                                     # (ops/hashgrid.VJP_MODES)
        "mesh_chunk": 2097152,
        "data_parallel": 1,          # ranks training one scene
                                     # (parallel/sharding.py)
        "chain_steps": True,         # the epoch loop's real steps replay
                                     # a CUDA graph of the step (one
                                     # process or NCCL ranks; the CPU and
                                     # gloo ranks run its body)
        "remat_virtual": True,       # recompute the virtual render and the
                                     # VAE encoder in the backward
                                     # (torch.utils.checkpoint)
        "donate_state": True,        # TPU dispatch only; ignored
    },
}


def merge_defaults(config: dict) -> dict:
    """Deep-merge a loaded YAML dict over DEFAULTS."""
    out = copy.deepcopy(DEFAULTS)
    for section, params in (config or {}).items():
        if section not in out:
            out[section] = {}
        if isinstance(params, dict):
            out[section].update(params)
        else:
            out[section] = params
    return out


def load_config(path: str) -> dict:
    with open(path, "r") as f:
        cfg = yaml.full_load(f)
    return merge_defaults(cfg)


def parse_cli(argv: list[str] | None = None) -> dict:
    """``--config x.yaml [section --key value ...]`` (reference CLI surface)."""
    parser = argparse.ArgumentParser(description="morpheus_tpu_torch trainer")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to the YAML config file")
    args, remaining = parser.parse_known_args(argv)
    if args.config is None:
        parser.error("--config is required")

    config = load_config(args.config)

    subparsers = parser.add_subparsers(dest="section", help="Config section")
    for section_name, section_params in config.items():
        sub = subparsers.add_parser(section_name)
        for key, value in section_params.items():
            sub.add_argument(f"--{key}", default=value, type=type(value))

    args = parser.parse_args(remaining)
    if getattr(args, "section", None) in config:
        for key, value in vars(args).items():
            if key not in ("section", "config") and value is not None:
                config[args.section][key] = value
    return config


def dump_config(config: dict, workspace: str, name: str = "config.yaml") -> None:
    """Snapshot the resolved config into the workspace (reference:
    morpheus.py:1551-1552); the eval worker rebuilds the dataset from it."""
    os.makedirs(workspace, exist_ok=True)
    with open(os.path.join(workspace, name), "w") as f:
        yaml.dump(config, f)
