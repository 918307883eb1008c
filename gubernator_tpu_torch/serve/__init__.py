"""The serving core on one CUDA device (the port of gubernator_tpu.serve).

Instance -> DeviceBatcher (arrival prep, deep batches, pipelined fetch)
-> TorchBackend -> TorchEngine (or the host ExactBackend), with the
over-limit shed cache, the sketch promoter loop, the GLOBAL manager and
the durability managers (replication, rescale, checkpoint) beside them;
the doors
(`server`: gRPC V1 + PeersV1, the HTTP JSON gateway, /metrics) and the
static discovery pool around them. The serving core imports torch, numpy,
prometheus_client and the standard library only: grpc, aiohttp and
protobuf load with the doors (`server`) or when a peer client first
dials another node.
"""
