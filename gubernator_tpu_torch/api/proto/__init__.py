"""Wire schema of the V1 and PeersV1 services (the port's copy)."""
