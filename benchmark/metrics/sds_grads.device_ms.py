"""Device busy ms per call of the program's sds.grads span (train/
trainer.py virtual_step: the whole SDS backward, launched by autograd's
thread inside it: render, recomputations, the VAE encoder's backward)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.span_device_ms("sds.grads")
