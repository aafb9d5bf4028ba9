"""The port's entry points of __graft_entry__.py.

    fn, args = entry()                 # the flagship field's forward render
    image, depth, opacity = fn(*args)
    dryrun_multichip(2)                # one data-parallel step, gloo ranks

entry() builds the tiny trainer of __graft_entry__._tiny_config (a 4-level
hash grid on a 4-frame 16^2 synthetic scene) and returns fn, which renders
rays (rays_o, rays_d, rays_t, rays_id) through renderer.render_rays with
the trainer's field and occupancy grid on a white background, train=False,
and the frame 0 rays as its example arguments. On the card by default;
device="cpu" runs it on the CPU.
"""
from __future__ import annotations

from .utils import Draws


def _tiny_config() -> dict:
    from .config import merge_defaults
    return merge_defaults({
        "data": {"data_dir": "<synthetic>"},
        "exp": {"seed": 0},
        "train": {"real_ray_num": 64, "normal_smoothness": 0.0,
                  "normal_smooth_3d": 0.0},
        "model": {"bg_radius": 0.0, "grid_num_levels": 4,
                  "grid_log2_hashmap_size": 10, "grid_desired_resolution": 32},
        "render": {"step_size": 0.04},
        "tpu": {"max_samples_per_ray": 16, "march_steps": 64,
                "occ_resolution": 16, "occ_warmup_steps": 4,
                "occ_update_every": 4},
    })


def _tiny_trainer(device="cuda", ray_num: int = 64):
    from .data.dataset import DeformDataset
    from .data.synthetic import make_synthetic_scene
    from .train.trainer import Trainer
    cfg = _tiny_config()
    cfg["train"]["real_ray_num"] = ray_num
    scene = make_synthetic_scene(num_frames=4, H=16, W=16)
    return Trainer(cfg, DeformDataset(cfg, scene=scene), device=device)


def entry(device="cuda", trainer=None, draws=None):
    """(fn, example_args): the forward render of the flagship model, rays in,
    (image, depth, opacity) out (module doc). trainer: the tiny trainer to
    render (default: a fresh one on `device`); draws: a callable giving the
    draw source of one call (default: a fresh Draws(device, 0) each call,
    so that two calls render alike)."""
    from . import renderer
    from .data.dataset import full_frame_rays
    trainer = _tiny_trainer(device) if trainer is None else trainer
    dev = trainer.device
    draws = draws or (lambda: Draws(dev, 0))
    rays = full_frame_rays(trainer.data, trainer.dataset.num_frames, 0)

    def fn(rays_o, rays_d, rays_t, rays_id):
        out = renderer.render_rays(
            trainer.field, trainer.occ, draws(), rays_o, rays_d, rays_t,
            rays_id, trainer.rcfg, bg_color=1.0, train=False)
        return tuple(out[k].detach() for k in ("image", "depth", "opacity"))

    return fn, (rays["rays_o"], rays["rays_d"], rays["rays_t"],
                rays["rays_id"])


def dryrun_multichip(n_devices: int) -> None:
    """One data-parallel real and virtual step on n_devices gloo ranks of
    the CPU (parallel/dryrun.py)."""
    from .parallel.dryrun import dryrun
    dryrun(n_devices)


if __name__ == "__main__":
    import sys
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    f, args = entry(dev)
    print("entry OK:", [tuple(o.shape) for o in f(*args)])
