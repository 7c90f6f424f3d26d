"""The device mesh of the distributed compaction.

Counterpart of yugabyte_tpu/parallel/mesh.py. JAX's `shard_map` is
single-controller: one Python call in one process drives every device of
the `Mesh`, and its callers (the compaction router, the compaction pool's
wave) rely on that. The port keeps that shape: a `Mesh` is a list of torch
devices driven from one process, and the collectives of the JAX program
become copies between the shards' tensors (within one device when the
shards share it, peer copies through `Tensor.to` across cards).

Repeats are allowed: `make_mesh(8, devices=[torch.device("cuda", 0)] * 8)`
is 8 virtual shards on one card, as the JAX tests' 8 forced host devices
are 8 shards on one CPU.

Axis "shard": the range-sharding of the key space within one job (ref:
compaction_job.cc:330 GenSubcompactionBoundaries, one device per key
range), or one pooled job per slot.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from yugabyte_tpu_torch.utils import torch_setup


class Mesh:
    """One mesh axis over torch devices. `devices` is a numpy object array
    of `torch.device`s, so `mesh.devices.size` and `mesh.devices.flat`
    read as they do on a JAX mesh."""

    def __init__(self, devices: Sequence[torch.device], axis: str = "shard"):
        self.devices = np.empty(len(devices), dtype=object)
        for i, d in enumerate(devices):
            self.devices[i] = d
        self.axis = axis

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(n_shards: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis: str = "shard") -> Mesh:
    """A mesh over `devices` (each resolved as the port's entry points
    resolve a device: a CUDA device raises without CUDA), or, with
    devices=None, over every visible CUDA device; it raises without CUDA.
    n_shards keeps the first n_shards devices, as the JAX function does."""
    if devices is None:
        torch_setup.resolve_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch_setup.resolve_device(d) for d in devices]
    if n_shards is not None:
        devs = devs[:n_shards]
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(devs, axis)
