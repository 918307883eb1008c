"""Generated protobuf modules: copies of gubernator_tpu/api/proto/gen/.

Each serialized descriptor is kept byte for byte (file names
`gubernator.proto` and `peers.proto`, proto package `pb.gubernator`), so
the wire paths (`/pb.gubernator.V1/GetRateLimits`) and messages are the
reference's and its clients interoperate. Only the module paths differ:
the modules import each other by package path instead of putting this
directory on sys.path. Loaded beside the JAX package's copy in one
process, the identical descriptors resolve to the same message classes.
"""

from gubernator_tpu_torch.api.proto.gen import gubernator_pb2, peers_pb2

__all__ = ["gubernator_pb2", "peers_pb2"]
