"""GB/s of the device-to-host copies in the traced window: their bytes over
their device time (the copy engine's rate while the next chunk computes)."""


def read(trace):
    copies = trace.copies("DtoH")
    seconds = sum(c.dur for c in copies) / 1e6
    if not copies or seconds <= 0:
        return None
    return sum(c.nbytes for c in copies) / seconds / 1e9
