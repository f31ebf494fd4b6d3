"""The share of the encoder's tile slots that hold a tile: 100 * the
program's ``tiles`` counter over its ``tile_slots`` (``inference/tiled.py``,
``encode_tiles``: the last tile batch is padded by repeating the last tile),
over the traced requests.  A count, which repeats exactly."""

KIND = "uq"


def read(r):
    if r.kind != KIND or not r.traced_items or not r.counters.get("tile_slots"):
        return None
    return 100.0 * r.counters["tiles"] / r.counters["tile_slots"]
