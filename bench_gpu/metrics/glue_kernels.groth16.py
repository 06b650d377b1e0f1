"""Kernels a verify call launches that are not the port's own CUDA kernels
(those of ``libpairing_kernels.so``, all named ``k_*``): the plain PyTorch
glue of the field library, the curves and the ops wrappers. A count."""

from bench_gpu.tracing import is_own_kernel


def read(trace):
    if not trace.n_steps:
        return None
    glue = [k for k in trace.kernels() if not is_own_kernel(k.name)]
    return len(glue) / trace.n_steps
