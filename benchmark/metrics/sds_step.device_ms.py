"""Device busy ms per call of the SDS virtual step (the span around
Trainer.virtual_step: render, resize, guidance, the VAE encoder's backward,
the freeze or the carry)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.span_device_ms("virtual_step")
