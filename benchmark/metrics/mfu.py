"""Model FLOPs of the window's steps over the window's time, against the
card's dense bf16 peak (%). The FLOPs of a step of each kind are the
reference's, counted by FlopCounterMode (matrix products and convolutions,
forward and backward) on the same inputs; the window's steps are weighted
by the cell's mix of kinds."""


def read(run):
    if not run.peaks or not run.flops:
        return None
    steps = run.rec["steps_by_kind"]
    if any(k not in run.flops for k in steps):
        return None
    flops = sum(n * run.flops[k] for k, n in steps.items())
    return 100.0 * flops / run.rec["window_s"] / run.peaks["bf16_flops"]
