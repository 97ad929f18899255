"""Data parallelism over torch.distributed: the mesh, a multi-process
self-check and a weak-scaling harness."""
