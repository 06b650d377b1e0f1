"""Streaming and parallelism over ``torch.distributed``; the counterpart of
``pairing_tpu/parallel/``.

  runner.pairing_stream        chunked, checkpointed streaming of huge batches
  mesh.make_mesh               a DeviceMesh over the initialized process group
  mesh.pairing_data_parallel   independent pairings split over a mesh axis
  mesh.multi_pairing_sharded   a K-pair product split over a mesh axis
  collectives                  Fq12-product all-reduces over a process group
  launch                       init_distributed, the hybrid mesh, a smoke run
"""
