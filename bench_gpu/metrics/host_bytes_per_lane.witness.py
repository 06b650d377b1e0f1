"""Bytes of the host arrays a chunk of the witness stream hands over (the
union of the byte ranges its numpy leaves span), over the chunk's lanes. A
count the run takes from what it was handed."""


def read(trace):
    return trace.counters.get("host_bytes_per_lane")
