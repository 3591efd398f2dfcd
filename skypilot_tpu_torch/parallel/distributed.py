"""The gang environment of a multi-host job (mirrors
`skypilot_tpu/parallel/distributed.py`).

The gang-exec layer exports SKYTPU_HOST_RANK, SKYTPU_NUM_HOSTS,
SKYTPU_NUM_SLICES and SKYTPU_COORDINATOR_ADDRESS on every host (the
names are the reference's, `skypilot_tpu/skylet/constants.py`; the port
keeps its own copy).  The reference brings up `jax.distributed` from
them.  The port trains on the devices of one process: a job of several
hosts needs a `torch.distributed` group for the DCN 'data' axis,
composed with each host's device list, which is ROADMAP item A17f, so
`initialize_from_env` refuses one rather than train each host alone.
"""
from __future__ import annotations

import os

ENV_HOST_RANK = 'SKYTPU_HOST_RANK'          # global host rank, 0..N-1
ENV_NUM_HOSTS = 'SKYTPU_NUM_HOSTS'
ENV_NUM_SLICES = 'SKYTPU_NUM_SLICES'        # multislice (DCN) width
ENV_COORDINATOR_ADDRESS = 'SKYTPU_COORDINATOR_ADDRESS'  # host0_ip:port


def initialize_from_env(*, force: bool = False) -> bool:
    """False when the job runs on one host (no gang env: nothing to
    do), as the reference returns without its coordinator; raises
    NotImplementedError for SKYTPU_NUM_HOSTS > 1."""
    del force
    if num_hosts() <= 1:
        return False
    raise NotImplementedError(
        f'{ENV_NUM_HOSTS}={num_hosts()}: multi-host training (a '
        'torch.distributed group for the DCN data axis, composed with '
        'each host\'s device list) is ROADMAP item A17f, a later slice of '
        'the port; run on one host with --mesh-devices')


def num_slices() -> int:
    return int(os.environ.get(ENV_NUM_SLICES, '1'))


def num_hosts() -> int:
    return int(os.environ.get(ENV_NUM_HOSTS, '1'))


def host_rank() -> int:
    return int(os.environ.get(ENV_HOST_RANK, '0'))
