"""The plain reference of the benchmark's cells: the port's real and SDS
steps frozen into plain PyTorch (no kernel, no CUDA graph, no process
group), computed in float32 with TF32 off and the UNet in the type the
configuration states. It imports nothing of the port, of the JAX package or
of JAX."""
