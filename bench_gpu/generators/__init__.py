"""Input generators, one module per kind, found by the ``"generator"`` key
of a traffic file (``traffic/<mix>.json``): ``generators/<kind>.py``
defines ``make(seed, **params)``, which gets the traffic file's keys as its
parameters. The curve arithmetic they share is in ``generate.py``.
"""
