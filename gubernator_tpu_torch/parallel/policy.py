"""Sharding policy: the one object that decides how an engine lays its
state and batches over devices (PyTorch port of
gubernator_tpu/parallel/policy.py).

The reference carries a jax Mesh and the NamedSharding specs of its
shard_map programs. The port's shards live in ONE process: shard `s`'s
store, sketch and sub-batch live on `devices[s]`, and a "collective" is
a loop over the shard list (parallel/sharded.py). A device may appear
more than once, the port's counterpart of XLA's simulated host devices:
on one GPU, or on the CPU, N shards share one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from gubernator_tpu_torch.core.store import DeviceLike, resolve_device


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

    - `devices`: the shards, in shard-index order (None on the flat
      single-device policy, whose one device is `device`).
    - `axes`: mesh axis names, host-major: ("shard",) flat 1-D, or
      ("host", "chip") when the reductions stage within a host first
      (BASELINE config 5's hierarchical psum). Empty for single.
    - `shape`: the size of each axis (empty for single).
    - `spans_processes`: always False in the port (multi-host is not
      ported); kept so callers read the reference's field.
    """

    device: Optional[torch.device] = None
    devices: Optional[Tuple[torch.device, ...]] = None
    axes: Tuple[str, ...] = ()
    shape: Tuple[int, ...] = ()
    spans_processes: bool = False

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

    # -- derived properties -------------------------------------------------

    @property
    def flat(self) -> bool:
        """True for the degenerate single-device policy."""
        return self.devices is None

    @property
    def n_shards(self) -> int:
        return 1 if self.flat else len(self.devices)

    @property
    def hierarchical(self) -> bool:
        """Stage the cross-shard reductions chip-then-host (2-D mesh)."""
        return len(self.axes) > 1

    def host_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """The shard indices of each host, host-major (one group holding
        every shard on a 1-D mesh): the stages of _hier_psum."""
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
        return (
            f"{self.n_shards}-shard mesh {shape} axes={self.axes} "
            f"collective={'hierarchical' if self.hierarchical else 'flat'}"
            f"{' multi-process' if self.spans_processes else ''}"
        )
