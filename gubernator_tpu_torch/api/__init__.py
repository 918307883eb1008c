"""Wire-level API types (a copy of gubernator_tpu.api.types)."""
