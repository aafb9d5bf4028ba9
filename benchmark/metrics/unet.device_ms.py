"""Device busy ms per call of the program's guidance.unet span (guidance/
zero123.py sds_loss: the UNet forward at CFG batch 2)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.span_device_ms("guidance.unet")
