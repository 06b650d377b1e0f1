"""One module per configuration kind, named by a configuration's ``driver`` key.

A driver module defines ``Driver(config, traffic, seed, device, control)``
with ``setup(inputs, seconds)`` (``inputs`` from the traffic mix's
generator), ``start()``, ``step() -> units``, ``stop()``,
``release()`` and ``check() -> {"checks": [(name, value, limit)],
"attempted", "failed"}``, and the attributes ``traced``, ``shapes`` and
``counters`` that the traced run reads.
"""
