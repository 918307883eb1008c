"""The serving core on one CUDA device (the port of gubernator_tpu.serve).

Instance -> DeviceBatcher (arrival prep, deep batches, pipelined fetch)
-> TorchBackend -> TorchEngine, with the over-limit shed cache, the
sketch promoter loop and the GLOBAL manager beside them. Imports torch,
numpy, prometheus_client and the standard library only: no grpc, aiohttp
or protobuf (the doors that need them are not ported yet).
"""
