"""The device's idle share: 1 - (device busy seconds an item) / (seconds an
item of the measured window).  Busy is the union of the device events'
intervals in the traced segment, over its items; the seconds an item are
the untraced window's, since the trace's own host cost (a callback a
kernel launch) stretches a host-bound traced segment by half and would
count as idle."""

KIND = "predict"


def read(r):
    if r.kind != KIND or r.tracer is None or not r.traced_items or not r.items:
        return None
    busy = r.tracer.busy_s() / r.traced_items
    return 100.0 * (1.0 - busy * r.items / r.work_s)
