"""Host ms a verify call inside the Miller loop's plain glue: the ranges
``miller_loop.N_normalize.points`` (the epilogue points and z),
``miller_loop.N_normalize.inverse`` (the Fq2 inverse around kernel F) and
``miller_loop.C_lines.epilogue`` (the two epilogue lines)."""

from bench_gpu.metrics._spans import host_ms

GLUE = ("miller_loop.N_normalize.points", "miller_loop.N_normalize.inverse",
        "miller_loop.C_lines.epilogue")


def read(trace):
    return host_ms(trace, GLUE)
