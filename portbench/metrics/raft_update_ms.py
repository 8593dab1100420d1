"""Model layer: device ms a pair in RAFT's ``raft_update`` span (its 24
lookups and updates and the convex upsampling), the traced part's
device operations placed in the span by correlation id
(``drivers/stream_raft.py`` ``read_spans``). None where the program
recorded no such span."""


def read(run, name):
    return (getattr(run, "span_device_ms", None) or {}).get("raft_update")
