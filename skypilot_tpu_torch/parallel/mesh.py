"""Device meshes with the reference's [dcn, ici] axis order (mirrors
`skypilot_tpu/parallel/mesh.py`).

A mesh is a list of torch devices laid out row-major over named axes:
`axis_names` (outermost first), `shape` ({axis: size}) and `devices`
(one entry per mesh position).  `build_mesh` gives the reference's six
axes, DCN axes first ('data', 'pipeline'), then the ICI axes ('fsdp',
'sequence', 'tensor', 'expert'), with at most one size inferred.
Entries may repeat one device: a list that names `cuda:0` four times
is four emulated devices on one card, the counterpart of the
reference's `xla_force_host_platform_device_count` virtual devices,
and a list of CPU entries is the same on the host.  Entries are
distinct by `torch.device` equality (`distinct_devices`): a sharded
state keeps one copy of a replicated block on each distinct entry that
holds it (parallel/sharding.py), so `['cpu'] * 4` keeps one, while the
indexed CPU entries `cpu:0 ... cpu:3` keep four in host memory, the
CPU's stand-in for four cards.  Where the
reference lets GSPMD insert collectives over a mesh, the port's
modules move tensors between the entries themselves
(parallel/sharding.py).

Across hosts (a gang: the `torch.distributed` group of
parallel/distributed.py), `build_mesh` lays the axes out over every
host's devices, host h holding the global positions [h n, (h + 1) n)
of its n entries, row-major over (data, pipeline, fsdp, sequence,
tensor, expert), as the reference lays them out over `jax.devices()`,
and returns the host's own part: every ICI axis whole, and a block of
the DCN axes' coordinates, either whole stages of some data
coordinates ('data' cut by the hosts) or some consecutive stages of
one data coordinate ('pipeline' cut as well).  `Mesh.hosts`,
`Mesh.host_rank`, `Mesh.global_shape`, the host's `offsets` along
'data' and 'pipeline' and `host_grid` (the hosts along each) say which
part.  A layout that splits an ICI axis over hosts raises (ROADMAP
item A17f-iii).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from skypilot_tpu_torch.parallel import distributed

# Standard mesh axis names, outermost first.  'data' and 'pipeline' may
# span DCN (across slices); 'fsdp', 'sequence', 'tensor', 'expert' stay
# inside a slice (ICI).
DCN_AXES = ('data', 'pipeline')
ICI_AXES = ('fsdp', 'sequence', 'tensor', 'expert')

# chips per host for each TPU generation (v4/v5p: 4 chips/host;
# v5e/v6e: 8 chips/host for the 2x4 host form factor).
_CHIPS_PER_HOST = {
    'v2': 4, 'v3': 4, 'v4': 4, 'v5p': 4,
    'v5e': 8, 'v5litepod': 8, 'v6e': 8,
}


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """Physical shape of one TPU slice."""
    generation: str          # 'v5p', 'v5e', ...
    num_chips: int           # total chips in the slice
    num_hosts: int           # TPU-VM workers in the slice
    chips_per_host: int

    @property
    def accelerator_name(self) -> str:
        return f'tpu-{self.generation}-{self.num_chips}'


def slice_topology(accelerator: str) -> SliceTopology:
    """Parse 'tpu-v5p-64' / 'v5e-8' into a SliceTopology (counts are
    chips, except that v2/v3 names count cores, two a chip)."""
    name = accelerator.lower()
    if name.startswith('tpu-'):
        name = name[len('tpu-'):]
    parts = name.rsplit('-', 1)
    if len(parts) != 2 or not parts[1].isdigit():
        raise ValueError(f'Cannot parse TPU accelerator name: {accelerator!r}')
    gen, count = parts[0], int(parts[1])
    if gen not in _CHIPS_PER_HOST:
        raise ValueError(f'Unknown TPU generation {gen!r} in {accelerator!r}')
    num_chips = count // 2 if gen in ('v2', 'v3') else count
    chips_per_host = _CHIPS_PER_HOST[gen]
    num_hosts = max(1, math.ceil(num_chips / chips_per_host))
    return SliceTopology(generation=gen, num_chips=num_chips,
                         num_hosts=num_hosts,
                         chips_per_host=min(chips_per_host, num_chips))


@dataclasses.dataclass
class MeshConfig:
    """Requested logical mesh: axis name -> size.  Sizes of -1 are
    inferred (at most one per group)."""
    data: int = -1
    pipeline: int = 1
    fsdp: int = 1
    sequence: int = 1
    tensor: int = 1
    expert: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {
            'data': self.data, 'pipeline': self.pipeline,
            'fsdp': self.fsdp, 'sequence': self.sequence,
            'tensor': self.tensor, 'expert': self.expert,
        }


def _infer(sizes: List[int], total: int, what: str) -> List[int]:
    """Fill in at most one -1 so that prod(sizes) == total."""
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise ValueError(f'At most one inferred (-1) axis allowed in {what}')
    known = math.prod(s for s in sizes if s != -1)
    if unknown:
        if total % known != 0:
            raise ValueError(
                f'{what}: cannot infer axis; {total} devices not divisible '
                f'by product of fixed axes {known}')
        sizes = list(sizes)
        sizes[unknown[0]] = total // known
    elif known != total:
        raise ValueError(
            f'{what}: axis sizes multiply to {known}, but there are '
            f'{total} devices')
    return sizes


def elastic_mesh_config(config: MeshConfig,
                        num_devices: int) -> MeshConfig:
    """Re-infer the batch axes (data, fsdp) of `config` for a new device
    count, keeping the model axes (pipeline, sequence, tensor, expert)
    fixed: fsdp keeps the largest size that divides the new parallel
    capacity (gcd with the requested size), data absorbs the rest."""
    sizes = config.axis_sizes()
    fixed = 1
    for axis in ('pipeline', 'sequence', 'tensor', 'expert'):
        if sizes[axis] == -1:
            raise ValueError(
                f'model axis {axis!r} cannot be inferred (-1) in an '
                f'elastic resize; only data/fsdp rescale')
        fixed *= sizes[axis]
    if num_devices <= 0 or num_devices % fixed != 0:
        raise ValueError(
            f'{num_devices} device(s) not divisible by the model-axis '
            f'product {fixed} (pipeline*sequence*tensor*expert)')
    parallel = num_devices // fixed
    data, fsdp = sizes['data'], sizes['fsdp']
    if fsdp == -1 and data == -1:
        fsdp, data = parallel, 1
    elif fsdp == -1:
        if parallel % data != 0:
            raise ValueError(
                f'data={data} does not divide the parallel capacity '
                f'{parallel} of {num_devices} devices')
        fsdp = parallel // data
    else:
        fsdp = math.gcd(fsdp, parallel)
        data = parallel // fsdp
    return MeshConfig(data=data, pipeline=sizes['pipeline'], fsdp=fsdp,
                      sequence=sizes['sequence'], tensor=sizes['tensor'],
                      expert=sizes['expert'])


class Mesh:
    """Devices over named axes (row-major: the last axis varies
    fastest)."""

    def __init__(self, devices: Sequence[Union[str, torch.device]],
                 axes: Dict[str, int], *, hosts: int = 1,
                 host_rank: int = 0,
                 global_axes: Optional[Dict[str, int]] = None,
                 offsets: Optional[Dict[str, int]] = None) -> None:
        self.axis_names = tuple(axes)
        # The hosts whose meshes make up the global one, and which of
        # them this is.
        self.hosts = int(hosts)
        self.host_rank = int(host_rank)
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
        if global_axes is None:
            # 'data' alone spans the hosts.
            global_axes = {name: size * (self.hosts if name == 'data' else 1)
                           for name, size in self.shape.items()}
        self._global = {name: int(global_axes.get(name, size))
                        for name, size in self.shape.items()}
        self.offsets = {axis: int((offsets or {}).get(axis, 0))
                        for axis in DCN_AXES}
        if math.prod(self._global.values()) != self.hosts * self.size:
            raise ValueError(f'global axes {self._global} over {self.hosts} '
                             f'hosts of {self.size} positions')

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def global_shape(self) -> Dict[str, int]:
        """The axes over every host's devices."""
        return dict(self._global)

    @property
    def host_grid(self) -> Tuple[int, int]:
        """(hosts along 'data', hosts along 'pipeline'): host h sits at
        divmod(h, hosts along 'pipeline') of that grid."""
        return tuple(self._global.get(a, 1) // self.shape.get(a, 1)
                     for a in DCN_AXES)

    @property
    def global_stage(self) -> int:
        """The global index of this host's first pipeline stage."""
        return self.offsets['pipeline']

    def coords(self, position: int) -> Dict[str, int]:
        """{axis: index} of a mesh position (an index into devices)."""
        out = {}
        for name in reversed(self.axis_names):
            position, out[name] = divmod(position, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def position(self, **coords: int) -> int:
        """The position at `coords` (axes left out at index 0)."""
        pos = 0
        for name in self.axis_names:
            pos = pos * self.shape[name] + int(coords.get(name, 0))
        return pos

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices, each once, in order of first position."""
        return list(dict.fromkeys(self.devices))

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The devices along `axis_name`, every other axis at index 0
        (a mesh without the axis: its first device)."""
        if axis_name not in self.shape:
            return self.devices[:1]
        return [self.devices[self.position(**{axis_name: i})]
                for i in range(self.shape[axis_name])]

    def __repr__(self) -> str:
        return f'Mesh({self.shape}, devices={[str(d) for d in self.devices]})'


def default_devices(device: Union[str, torch.device, None] = 'cuda'
                    ) -> List[torch.device]:
    """Every visible CUDA device (raising without CUDA), or one entry
    for device='cpu'."""
    from skypilot_tpu_torch.device import resolve_device  # pylint: disable=import-outside-toplevel
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return [dev]
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def _host_block(sizes: Dict[str, int], hosts: int, host_rank: int
                ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """-> (the host's axes, its offsets along 'data' and 'pipeline') of
    the global layout `sizes` over `hosts` hosts.  Host h holds global
    positions [h n, (h + 1) n): every ICI axis whole and k = n / ICI
    consecutive (data, pipeline) coordinates, which must be whole
    stages of k / pipeline data coordinates, or k consecutive stages of
    one.  Hosts that split an ICI axis raise (A17f-iii); a DCN grid the
    hosts do not divide into such blocks raises ValueError."""
    data, stages = sizes['data'], sizes['pipeline']
    dcn = data * stages
    if dcn % hosts:
        if hosts % dcn:
            raise ValueError(
                f"global 'data' x 'pipeline' size {dcn} ({data} x {stages}) "
                f'not divisible by the {hosts} hosts: each host holds whole '
                '(data, pipeline) coordinates')
        split, across = hosts // dcn, []
        for axis in ICI_AXES:
            if split > 1 and sizes[axis] > 1:
                across.append(axis)
                split //= math.gcd(split, sizes[axis])
        raise NotImplementedError(
            f'{hosts} hosts over the global mesh {sizes} put {across} across '
            "hosts: only 'data' and 'pipeline' span hosts; an ICI axis "
            'across hosts is ROADMAP item A17f-iii, a later slice of the '
            'port')
    k = dcn // hosts
    local = dict(sizes)
    if k % stages == 0:
        local['data'] = k // stages
        offsets = {'data': host_rank * local['data'], 'pipeline': 0}
    elif stages % k == 0:
        local['data'], local['pipeline'] = 1, k
        d, p = divmod(host_rank * k, stages)
        offsets = {'data': d, 'pipeline': p}
    else:
        raise ValueError(
            f'{hosts} hosts of {k} (data, pipeline) coordinates each over '
            f"{data} x {stages}: a host holds whole stages of some data "
            'coordinates or consecutive stages of one')
    return local, offsets


def build_mesh(config: Optional[MeshConfig] = None,
               devices: Optional[Sequence[Union[str, torch.device]]] = None,
               *, num_slices: int = 1, hosts: Optional[int] = None,
               host_rank: Optional[int] = None) -> Mesh:
    """The mesh of `config` over `devices` (default: every visible CUDA
    device) with the axes in [dcn, ici] order.  With num_slices > 1,
    consecutive blocks of (global) devices / num_slices entries stand
    in for slices, as the reference lays out devices that carry no
    slice_index: the ICI axes are inferred within a slice and the DCN
    axes across slices.

    `hosts` / `host_rank` (default: the process group's,
    `distributed.gang()`, one host without a group): `devices` are
    this host's, the sizes are inferred over hosts x len(devices), and
    the mesh returned is this host's part of the global one (module
    docstring)."""
    config = config or MeshConfig()
    if devices is None:
        devices = default_devices()
    devices = list(devices)
    if hosts is None or host_rank is None:
        group_hosts, group_rank = distributed.gang()
        hosts = group_hosts if hosts is None else hosts
        host_rank = group_rank if host_rank is None else host_rank
    n = len(devices) * hosts
    sizes = config.axis_sizes()
    dcn_sizes = [sizes[a] for a in DCN_AXES]
    ici_sizes = [sizes[a] for a in ICI_AXES]
    if num_slices > 1:
        ici_sizes = _infer(ici_sizes, n // num_slices, 'ICI axes')
        dcn_sizes = _infer(dcn_sizes, num_slices, 'DCN axes')
    else:
        all_sizes = _infer(dcn_sizes + ici_sizes, n, 'mesh axes')
        dcn_sizes = all_sizes[:len(DCN_AXES)]
        ici_sizes = all_sizes[len(DCN_AXES):]
    axes = dict(zip(DCN_AXES + ICI_AXES, dcn_sizes + ici_sizes))
    if hosts <= 1:
        return Mesh(devices, axes)
    local, offsets = _host_block(axes, hosts, host_rank)
    return Mesh(devices, local, hosts=hosts, host_rank=host_rank,
                global_axes=axes, offsets=offsets)
