"""Device busy ms per call of Zero123's sds_loss (the span around
guidance.zero123.sds_loss: the VAE encoder's forward and the UNet at CFG
batch 2; the encoder's backward runs later, in the virtual step)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.span_device_ms("sds_loss")
