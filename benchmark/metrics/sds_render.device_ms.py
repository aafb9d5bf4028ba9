"""Device busy ms per call of the program's sds.render span (train/
trainer.py virtual_loss_from_batch: the view's march, compaction, field
forward, composite and regularisers; under remat_virtual its first pass
alone)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.span_device_ms("sds.render")
