"""Device-side core of the port: slot store, decide, writeback kernel,
engine glue. Plain PyTorch tensor code with an explicit `device`; the
resident store is updated in place where the JAX package donates it."""
