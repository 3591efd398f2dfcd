"""The slice mesh (mirrors the part of `skypilot_tpu/parallel/mesh.py`
that `serve/slice_replica.build_slice_mesh` uses).

A mesh is a list of torch devices laid out row-major over named axes:
`axis_names` (outermost first), `shape` ({axis: size}) and `devices`
(one entry per mesh position).  A slice replica's mesh has the axes
('sequence', 'tensor').  Entries may repeat one device: a list that
names `cuda:0` four times is four emulated hosts on one card, the
counterpart of the reference's `xla_force_host_platform_device_count`
virtual devices, and a list of CPU entries is the same on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Union

import torch


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Requested slice layout: the sequence and tensor factors."""
    sequence: int = 1
    tensor: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {'sequence': self.sequence, 'tensor': self.tensor}


class Mesh:
    """Devices over named axes (row-major: the last axis varies
    fastest)."""

    def __init__(self, devices: Sequence[Union[str, torch.device]],
                 axes: Dict[str, int]) -> None:
        self.axis_names = tuple(axes)
        self.shape = {name: int(size) for name, size in axes.items()}
        self.devices: List[torch.device] = [torch.device(d)
                                            for d in devices]
        if any(size < 1 for size in self.shape.values()):
            raise ValueError(f'mesh axes must be >= 1, got {self.shape}')
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError(
                f'mesh axes {self.shape} multiply to '
                f'{math.prod(self.shape.values())}, but there are '
                f'{len(self.devices)} devices')

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The devices along `axis_name`, every other axis at index 0
        (a mesh without the axis: its first device)."""
        if axis_name not in self.shape:
            return self.devices[:1]
        stride = math.prod(self.shape[a] for a in
                           self.axis_names[self.axis_names.index(
                               axis_name) + 1:])
        return [self.devices[i * stride]
                for i in range(self.shape[axis_name])]


def build_mesh(config: MeshConfig,
               devices: Sequence[Union[str, torch.device]]) -> Mesh:
    """The ('sequence', 'tensor') mesh of `config` over `devices` (as
    many as the factors multiply to)."""
    return Mesh(devices, config.axis_sizes())
