"""Sharding policy: the one object that decides how an engine lays its
state and batches over devices (PyTorch port of
gubernator_tpu/parallel/policy.py).

The reference carries a jax Mesh and the NamedSharding specs of its
shard_map programs. In the port a process holds a list of shards: shard
`s`'s store, sketch and sub-batch live on `devices[s]`, and a
"collective" within the process is a loop over the shard list
(parallel/sharded.py). A device may appear more than once, the port's
counterpart of XLA's simulated host devices: on one GPU, or on the CPU,
N shards share one device. A policy that spans processes
(`over_processes`, parallel/multihost.py) adds one torch.distributed
step over CROSS_PROCESS_BACKEND to each of those loops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from gubernator_tpu_torch.core.store import DeviceLike, resolve_device

#: the torch.distributed backend of a policy that spans processes: gloo,
#: on host buffers (NCCL refuses two ranks on one GPU, and a one-card
#: host is where the port runs today)
CROSS_PROCESS_BACKEND = "gloo"


def local_devices(device: DeviceLike = None) -> Tuple[torch.device, ...]:
    """Every device of this process of `device`'s kind: each CUDA device
    (cuda unless the caller names another; no GPU is the engine's own
    error), or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (dev,)


@dataclass(frozen=True)
class ShardingPolicy:
    """How one engine's state and batches map onto devices.

    - `devices`: this process's shards, in shard-index order (None on
      the flat single-device policy, whose one device is `device`).
    - `axes`: mesh axis names, host-major: ("shard",) flat 1-D, or
      ("host", "chip") when the reductions stage within a host first
      (BASELINE config 5's hierarchical psum). Empty for single.
    - `shape`: the size of each axis (empty for single).
    - `spans_processes`: the mesh crosses processes (multi-controller):
      process `process_index` of `process_count` holds the global shards
      `local_shards`, one "host" of the 2-D mesh; responses gather to the
      serving leader, process 0, and the owner-masked sums add one
      cross-process step.
    """

    device: Optional[torch.device] = None
    devices: Optional[Tuple[torch.device, ...]] = None
    axes: Tuple[str, ...] = ()
    shape: Tuple[int, ...] = ()
    spans_processes: bool = False
    process_index: int = 0
    process_count: int = 1

    # -- factories ----------------------------------------------------------

    @classmethod
    def single(cls, device: DeviceLike = None) -> "ShardingPolicy":
        """The degenerate policy: one shard, flat [B] batches, the
        single-device TorchEngine. `device` None keeps the engine's
        default (cuda unless the engine is told otherwise)."""
        return cls(device=None if device is None else torch.device(device))

    @classmethod
    def over_mesh(
        cls,
        devices: Optional[Sequence[DeviceLike]] = None,
        mesh_shape: Optional[Tuple[int, int]] = None,
    ) -> "ShardingPolicy":
        """Key-space sharding over a list of devices (every local CUDA
        device by default). `mesh_shape` (hosts, chips a host) forces
        the 2-D ("host", "chip") layout; its product must be the device
        count."""
        if devices is None:
            devices = local_devices()
        devs = tuple(resolve_device(d) for d in devices)
        n = len(devs)
        if n == 0:
            raise ValueError("a mesh policy needs at least one device")
        if mesh_shape is not None:
            n_hosts, per_host = mesh_shape
            if n_hosts * per_host != n:
                raise ValueError(f"mesh_shape {mesh_shape} != {n} devices")
            return cls(devices=devs, axes=("host", "chip"), shape=(n_hosts, per_host))
        return cls(devices=devs, axes=("shard",), shape=(n,))

    @classmethod
    def over_processes(
        cls, devices: Sequence[DeviceLike], process_index: int, process_count: int
    ) -> "ShardingPolicy":
        """This process's part of a mesh over `process_count` processes
        with len(devices) shards each: always the 2-D ("host", "chip")
        layout of shape (process_count, per), process-major, so process p
        holds the global shards [p * per, (p + 1) * per)."""
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh policy needs at least one device")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} is not one of {process_count}")
        return cls(devices=devs, axes=("host", "chip"), shape=(process_count, len(devs)),
                   spans_processes=True, process_index=process_index,
                   process_count=process_count)

    # -- derived properties -------------------------------------------------

    @property
    def flat(self) -> bool:
        """True for the degenerate single-device policy."""
        return self.devices is None

    @property
    def n_shards(self) -> int:
        """The GLOBAL shard count (every process's shards)."""
        return 1 if self.flat else len(self.devices) * self.process_count

    @property
    def local_shards(self) -> range:
        """The global indices of the shards this process holds."""
        per = 1 if self.flat else len(self.devices)
        return range(self.process_index * per, (self.process_index + 1) * per)

    @property
    def hierarchical(self) -> bool:
        """Stage the cross-shard reductions chip-then-host (2-D mesh)."""
        return len(self.axes) > 1

    def host_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """The shard indices of each host, host-major (one group holding
        every shard on a 1-D mesh): the in-process stages of _hier_psum.
        A process of a mesh that spans processes is one host: one group,
        its own shards by their positions in `devices`."""
        if self.spans_processes:
            return (tuple(range(len(self.devices))),)
        if not self.hierarchical:
            return (tuple(range(self.n_shards)),)
        n_hosts, per_host = self.shape
        return tuple(
            tuple(h * per_host + c for c in range(per_host)) for h in range(n_hosts)
        )

    def describe(self) -> str:
        if self.flat:
            return "single-device (flat, degenerate policy)"
        shape = dict(zip(self.axes, self.shape))
        spans = f" multi-process over {CROSS_PROCESS_BACKEND}" if self.spans_processes else ""
        return (
            f"{self.n_shards}-shard mesh {shape} axes={self.axes} "
            f"collective={'hierarchical' if self.hierarchical else 'flat'}{spans}"
        )
