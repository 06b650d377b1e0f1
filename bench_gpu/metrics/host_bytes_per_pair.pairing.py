"""Bytes of the host buffer a pairing call's values are copied into, over
the call's pairs (12 Fq coefficients of 21 int32 limbs: 1008). A count the
run takes from what it hands over."""


def read(trace):
    return trace.counters.get("host_bytes_per_pair")
