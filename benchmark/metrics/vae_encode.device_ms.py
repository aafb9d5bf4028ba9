"""Device busy ms per call of the program's guidance.vae_encode span
(guidance/zero123.py sds_loss: the VAE encoder's forward; its backward
runs in sds.grads)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.span_device_ms("guidance.vae_encode")
