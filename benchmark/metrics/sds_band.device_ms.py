"""Device busy ms per SDS step of the band term (renderer.py render_rays,
span render.band, eager in the SDS step: the traced epoch's replays open
no span, so each call is an SDS step's)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.span_device_ms("render.band")
