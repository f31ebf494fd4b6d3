"""Host microseconds a call of ``ops/_ext.call`` takes, entry to return
(the bound C function's lookup, the stream, the launch): the program's
``ext_call_ns`` counter over its ``ext_calls``, both counted in the traced
steps only.  Read under the trace's callback a launch."""


def read(r):
    if r.kind != "train" or not r.traced_items or not r.counters.get("ext_calls"):
        return None
    return r.counters["ext_call_ns"] / r.counters["ext_calls"] / 1000.0
