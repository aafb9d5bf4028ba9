"""Data parallelism over torch.distributed (port of morpheus_tpu/parallel/)."""
