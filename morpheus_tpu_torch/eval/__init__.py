"""Host-side evaluation of the port: culled 3-D mesh metrics, depth L1, the
detached eval worker (copies of morpheus_tpu/eval; numpy and scipy)."""
