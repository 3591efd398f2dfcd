"""The port's own weight checkpoints (the serving half of
`skypilot_tpu/data/checkpoints.py`).

Layout: a checkpoint directory holds numeric step directories; step N
is `<dir>/N/params.safetensors`, the reference tree's `params` leaves
keyed by their tree path joined with '/' (for example
`layers/layer/attn/q_proj/kernel`, an int8 leaf as `.../kernel/qvalue`
and `.../kernel/scale`), written and read by `utils/safetensors_io.py`.
The reference writes orbax steps, which need tensorstore; this format
needs nothing beyond numpy and torch.

- A step is written under a temporary name in the same directory and
  renamed into place, so `latest_step` never sees half a checkpoint.
- `restore_params` streams the leaves one at a time to the device
  (default 'cuda'), each through an optional `leaf_fn` (the server's
  cast or int8 quantization, models/convert.py:serving_leaf), so the
  tree as stored never exists on the device as a whole.
- A step directory without the port's file, such as an orbax step the
  JAX package wrote, is refused with `CheckpointFormatError`, never
  read as "no checkpoint": serving random weights from a directory
  that holds a real checkpoint would be the worst outcome.

Training checkpoints (the optimizer state) are not here yet.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple
from typing import Union

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.utils import safetensors_io

logger = logging.getLogger(__name__)

PARAMS_FILE = 'params.safetensors'
FORMAT = 'skypilot_tpu_torch.params'
_SEP = '/'
_REIMPORT = ('re-import its HF source with `python -m '
             'skypilot_tpu_torch.models.import_weights --src <hf dir> '
             '--out <dir>`')


class CheckpointFormatError(ValueError):
    """A step directory that is not one of this port's checkpoints."""


def _steps(directory: str):
    return [int(name) for name in os.listdir(directory)
            if name.isdigit() and
            os.path.isdir(os.path.join(directory, name))]


def _step_file(directory: str, step: int) -> str:
    path = os.path.join(directory, str(step))
    params = os.path.join(path, PARAMS_FILE)
    if os.path.isfile(params):
        return params
    what = 'no ' + PARAMS_FILE
    if any(os.path.exists(os.path.join(path, marker)) for marker in (
            '_CHECKPOINT_METADATA', '_METADATA', 'manifest.ocdbt',
            'default', 'params')):
        what = 'an orbax step, as the JAX package writes'
    raise CheckpointFormatError(
        f'{path} is not a skypilot_tpu_torch checkpoint ({what}); this '
        f'port reads only its own format: {_REIMPORT}')


def latest_step(directory: Optional[str]) -> Optional[int]:
    """The newest step under `directory`, or None when it holds none.
    Raises CheckpointFormatError when that step is not in this port's
    format."""
    if directory is None or not os.path.isdir(str(directory)):
        return None
    steps = _steps(str(directory))
    if not steps:
        return None
    step = max(steps)
    _step_file(str(directory), step)
    return step


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if _SEP in key:
            raise ValueError(f'tree key {key!r} holds {_SEP!r}')
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def save_leaves(directory: str, step: int,
                specs: Sequence[Tuple[Tuple[str, ...], torch.dtype,
                                      Sequence[int]]],
                leaves: Iterable[Tuple[Tuple[str, ...], Any]],
                overwrite: bool = False) -> str:
    """Write step `step` from leaves that `leaves` yields one at a time
    as (path, value) in the order of `specs` (path, dtype, shape); a
    value is a tensor or its slabs along axis 0
    (`safetensors_io.write_file`).  Atomic: written under a temporary
    name, then renamed.  An existing step is refused unless
    `overwrite`.  Returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    if os.path.exists(final) and not overwrite:
        raise ValueError(f'step {step} already exists under {directory}')
    tmp = tempfile.mkdtemp(prefix=f'.tmp-{step}-', dir=directory)
    try:
        path = os.path.join(tmp, PARAMS_FILE)
        safetensors_io.write_file(
            path, [(_SEP.join(p), dt, shape) for p, dt, shape in specs],
            ((_SEP.join(p), v) for p, v in leaves),
            metadata={'format': FORMAT, 'step': str(step)})
        with open(path, 'rb') as f:
            os.fsync(f.fileno())
        old = None
        if os.path.exists(final):
            old = tempfile.mkdtemp(prefix=f'.old-{step}-', dir=directory)
            os.rename(final, os.path.join(old, 'step'))
        os.rename(tmp, final)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def save_params(directory: str, step: int, params: Dict[str, Any]) -> str:
    """Save a reference-layout tree of tensors (any device, any dtype,
    int8 leaves included) as step `step`; see `save_leaves`."""
    flat = list(_flatten(params))
    specs = [(p, v.dtype, tuple(v.shape)) for p, v in flat]
    return save_leaves(directory, step, specs, flat)


def restore_params(directory: str, *,
                   device: Union[str, torch.device] = 'cuda',
                   leaf_fn: Optional[Callable[[Tuple[str, ...],
                                               torch.Tensor], Any]] = None,
                   step: Optional[int] = None) -> Any:
    """The params tree of the newest step (or `step`) under
    `directory`, its leaves streamed one at a time onto `device`, each
    through `leaf_fn(path, tensor)` when given.  Without a checkpoint,
    warns and returns None, as the reference returns its template."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
    if step is None:
        logger.warning('No checkpoint under %s.', directory)
        return None
    reader = safetensors_io.SafetensorsFile(_step_file(directory, step))
    try:
        if reader.metadata.get('format') != FORMAT:
            raise CheckpointFormatError(
                f'{reader.path}: format {reader.metadata.get("format")!r}, '
                f'not {FORMAT!r}: {_REIMPORT}')
        tree: Dict[str, Any] = {}
        for name in reader.keys():
            path = tuple(name.split(_SEP))
            leaf = reader.get_tensor(name).to(dev)
            if leaf_fn is not None:
                leaf = leaf_fn(path, leaf)
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
    finally:
        reader.close()
    logger.info('Restored params from step %d of %s', step, directory)
    return tree
