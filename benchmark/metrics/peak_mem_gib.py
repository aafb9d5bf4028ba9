"""The allocator's peak over the measured window (GiB):
torch.cuda.max_memory_allocated() after reset_peak_memory_stats() at the
window's start."""


def read(run):
    b = run.rec.get("window_peak_bytes")
    return b / 2 ** 30 if b else None
