"""PyTorch / CUDA port of morpheus_tpu (see README, "PyTorch / CUDA port")."""
