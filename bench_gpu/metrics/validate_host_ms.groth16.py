"""Host ms a verify call inside the port's ``validate.*`` ranges (their
union: ``validate.inputs``, the two ``validate.g1_on_curve`` of C and vk_x,
and the ranges nested in them). Unlike ``validate_ms.groth16`` it holds
none of the benchmark's synchronisations."""

from bench_gpu.metrics._spans import host_ms


def read(trace):
    return host_ms(trace, ("validate.",))
