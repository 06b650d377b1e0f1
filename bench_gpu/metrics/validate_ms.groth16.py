"""ms of the validation of a verify call (``validate_inputs`` with the
subgroup check on (A, B), ``g1_on_curve`` on C and vk_x): the benchmark's
``bench.validate`` span, which synchronises the device at both ends in a
traced run."""


def read(trace):
    spans = trace.named("bench.validate")
    if not spans:
        return None
    return sum(s.end - s.ts for s in spans) / 1e3 / len(spans)
