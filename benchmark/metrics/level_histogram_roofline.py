"""level_histogram's share of its roofline in the real steps (%): the least
time the card could take for the real steps' hash-grid cotangent
accumulation (rooflines/level_histogram.py's bytes over the card's HBM
rate) over the traced device time of the kernel's launches inside the
chained real step's span."""
from benchmark.rooflines import level_histogram


def read(run):
    tr = run.trace
    if tr is None or not run.peaks:
        return None
    launches, us = tr.kernel_us("level_histogram", "chained_real_step")
    calls = tr.span_calls("chained_real_step")
    if not launches or not calls:
        return None
    bound_s = calls * level_histogram.real_step_bytes(run.cfg, run.cell) \
        / run.peaks["hbm_bytes_per_s"]
    return 100.0 * bound_s / (us / 1e6)
