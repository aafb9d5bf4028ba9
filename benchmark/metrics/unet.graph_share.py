"""Share of the UNet's forwards that replayed a CUDA graph (%): 100 x
unet.replays / unet.calls, the program's host counters (morpheus_tpu_torch/
trace.py, counted by guidance/zero123.py apply_unet) over the whole run:
set-up, window and traced epoch. A program without the counters gives
None."""


def read(run):
    try:
        from morpheus_tpu_torch import trace
    except ImportError:
        return None
    c = trace.read()
    if not c.get("unet.calls"):
        return None
    return 100.0 * c.get("unet.replays", 0.0) / c["unet.calls"]
