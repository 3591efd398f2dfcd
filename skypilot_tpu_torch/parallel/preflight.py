"""Collective preflight: check that the mesh's links deliver before a
long job commits to them (mirrors `skypilot_tpu/parallel/preflight.py`).

`probe_collectives(mesh)` runs, for every mesh axis of size > 1, a sum
over the axis for real: each group of positions along the axis (one
group per index of the other axes) adds its payloads on the group's
first device and writes the sum back into every position's buffer.  A
tiny payload gives the latency and a `bandwidth_mb` one (per position)
the bus bandwidth, with the reference's formula 2 (n - 1) / n x payload
/ time, each the median of `repeats` runs on the host clock after a
sync.  `check_collectives` turns the numbers into pass/fail against the
reference's loose floors (a broken link is orders of magnitude off).

Across hosts (`mesh.hosts` > 1) the 'data' and 'pipeline' axes are
the global ones: a sum adds each host's positions along the axis
in-process, then the sums of the hosts of this host's data or
pipeline group (parallel/distributed.py), and its `size` is the global
size.

On a list that repeats one device (several positions of one card), the
moves are copies within that device's memory, not a fabric: the log
line says so.  A mesh of CPU entries is probed on one host thread: its
copies are what the probe measures, and PyTorch's intra-op thread pool
only adds waits when other processes share the cores.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.parallel import distributed

logger = logging.getLogger(__name__)

# Floors are deliberately loose: preflight catches BROKEN fabric
# (orders of magnitude off), not mild regressions.
DEFAULT_MIN_BANDWIDTH_GBPS = 0.05
DEFAULT_MAX_LATENCY_MS = 5000.0


def _groups(mesh, axis: str) -> List[List[int]]:
    """The positions along `axis`, one list per index of the other
    axes."""
    groups: Dict[tuple, List[int]] = {}
    for pos in range(mesh.size):
        coords = mesh.coords(pos)
        key = tuple(v for k, v in coords.items() if k != axis)
        groups.setdefault(key, []).append(pos)
    return list(groups.values())


def _sync(devices) -> None:
    for dev in devices:
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)


def _all_reduce(mesh, groups, buffers, hosts=distributed.SOLO) -> float:
    """Sum each group's buffers (and the sums of the `hosts` group of
    hosts, none by default) and write the sum back to each; -> a scalar
    read from the result (the host waits for the device)."""
    check = 0.0
    for group in groups:
        first = mesh.devices[group[0]]
        total = buffers[group[0]].clone()
        for pos in group[1:]:
            total += buffers[pos].to(first, non_blocking=True)
        distributed.all_reduce_sum_([total], hosts)
        for pos in group:
            buffers[pos].copy_(total, non_blocking=True)
        check += float(buffers[group[-1]][:8].sum())
    _sync(mesh.distinct_devices())
    return check


@contextlib.contextmanager
def _host_threads(mesh):
    """One intra-op thread while a mesh of CPU entries is probed."""
    if any(d.type != 'cpu' for d in mesh.devices):
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def probe_collectives(mesh, *, bandwidth_mb: float = 64.0,
                      repeats: int = 3) -> Dict[str, Dict[str, float]]:
    """{axis: {'size': n, 'psum_latency_ms': .., 'psum_gbps': ..}} for
    every mesh axis with size > 1."""
    with _host_threads(mesh):
        return _probe(mesh, bandwidth_mb, repeats)


def _probe(mesh, bandwidth_mb: float,
           repeats: int) -> Dict[str, Dict[str, float]]:
    results: Dict[str, Dict[str, float]] = {}
    for axis in [a for a in mesh.axis_names if mesh.global_shape[a] > 1]:
        n = mesh.global_shape[axis]
        across = n > mesh.shape[axis]
        # Across hosts: this host's data or pipeline group of hosts.
        hosts = (getattr(distributed.host_groups(*mesh.host_grid), axis)(
            mesh.host_rank) if across else distributed.SOLO)
        groups = _groups(mesh, axis)
        elems = max(8, int(bandwidth_mb * 1e6 / 4))
        tiny = [torch.ones(8, device=d) for d in mesh.devices]
        big = [torch.ones(elems, device=d) for d in mesh.devices]
        # Warm up outside the timed region.
        _all_reduce(mesh, groups, tiny, hosts)
        _all_reduce(mesh, groups, big, hosts)

        def timed(buffers) -> List[float]:
            out = []
            for _ in range(repeats):
                for b in buffers:
                    b.fill_(1.0)
                _sync(mesh.distinct_devices())
                t0 = time.perf_counter()
                _all_reduce(mesh, groups, buffers, hosts)
                out.append(time.perf_counter() - t0)
            return out
        lat, bw = timed(tiny), timed(big)
        per_rank_gb = elems * 4 / 1e9
        busbw = (2 * (n - 1) / n) * per_rank_gb / max(
            float(np.median(bw)), 1e-9)
        results[axis] = {
            'size': float(n),
            'psum_latency_ms': round(float(np.median(lat)) * 1e3, 3),
            'psum_gbps': round(busbw, 3),
        }
        one_device = not across and all(
            len({mesh.devices[p] for p in g}) == 1 for g in groups)
        logger.info('preflight[%s]: %s%s', axis, results[axis],
                    ' (every group repeats one device: the numbers are '
                    'copies within its memory, not a fabric)'
                    if one_device else '')
        del tiny, big
    return results


def check_collectives(mesh, *,
                      min_bandwidth_gbps: float = DEFAULT_MIN_BANDWIDTH_GBPS,
                      max_latency_ms: float = DEFAULT_MAX_LATENCY_MS,
                      results: Optional[Dict[str, Any]] = None) -> None:
    """Probe and raise if any axis is outside the health floors."""
    results = results if results is not None else probe_collectives(mesh)
    problems = []
    for axis, stats in results.items():
        if stats['psum_latency_ms'] > max_latency_ms:
            problems.append(
                f'{axis}: psum latency {stats["psum_latency_ms"]}ms '
                f'> {max_latency_ms}ms')
        if stats['psum_gbps'] < min_bandwidth_gbps:
            problems.append(
                f'{axis}: bandwidth {stats["psum_gbps"]}GB/s '
                f'< {min_bandwidth_gbps}GB/s')
    if problems:
        raise exceptions.SkyTpuError(
            'Collective preflight failed — the fabric is unhealthy; '
            'relaunch or exclude the slice: ' + '; '.join(problems))
