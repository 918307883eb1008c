"""Engines: the single-device TorchEngine and the MeshEngine over a list
of shards (the JAX package's PartitionedEngine under its two policies)."""
