"""Bytes of ``pairing_stream``'s checkpoint files over the pairs they hold
(the canonical limbs, 12 x 21 int32 a pair, 1008 B, with the digest and
the npz headers). A count the driver takes from the files."""


def read(trace):
    return trace.counters.get("checkpoint_bytes_per_pair")
