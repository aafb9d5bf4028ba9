"""Device busy ms per call of the program's occ.refresh span (train/
trainer.py _refresh_occ on a step that is due: the eager occupancy refresh
before a step's body)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.span_device_ms("occ.refresh")
