"""Share of the SDS virtual steps that replayed a CUDA graph (%): 100 x
sds.replays / sds.calls, the program's host counters (morpheus_tpu_torch/
trace.py, counted by train/trainer.py virtual_step and its graph's body)
over the whole run: set-up, window and traced epoch. A program without the
counters gives None."""


def read(run):
    try:
        from morpheus_tpu_torch import trace
    except ImportError:
        return None
    c = trace.read()
    if not c.get("sds.calls"):
        return None
    return 100.0 * c.get("sds.replays", 0.0) / c["sds.calls"]
