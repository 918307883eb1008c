"""Engines: the single-device TorchEngine (the flat half of the JAX
package's PartitionedEngine)."""
