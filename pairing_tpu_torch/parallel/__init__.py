"""Streaming over huge batches (``runner.pairing_stream``); the counterpart
of ``pairing_tpu/parallel/``. Its mesh, collectives and launcher over
``torch.distributed`` are not ported yet."""
