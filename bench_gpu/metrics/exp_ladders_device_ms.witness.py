"""Device ms a witness chunk of the kernels launched inside the port's
``witness.exp_ladders`` (the three K12 ladders) and
``witness.affine_export`` (K13) ranges."""

from bench_gpu.metrics._common import device_ms_in


def read(trace):
    return device_ms_in(trace, ("witness.exp_ladders", "witness.affine_export"))
