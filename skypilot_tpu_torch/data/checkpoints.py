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

The training half (the reference's checkpoint contract):
- `checkpoint_dir()` is SKYTPU_CHECKPOINT_DIR, which the job contract
  exports (a bucket mounted at CHECKPOINT_PATH on cluster hosts).
- A training step is one step directory, written atomically as above:
  `params.safetensors` in the format and layout above (so
  `restore_params` and `ModelServer(checkpoint_dir=...)` read a
  training step as they read an import, never opening the optimizer
  state), and `optimizer.safetensors` with the AdamW moments
  (`mu/<path>`, `nu/<path>`, f32) and, in its metadata, the optimizer's
  step count and the TrainState's step.  12 bytes a parameter.
- `restore_or_init(state, directory)` -> (state, saved step + 1), or
  (state, 0) without a checkpoint; `restore_sharded(directory,
  abstract, shardings)` restores onto another mesh's layout.  A
  sharded state writes the same files as an unsharded one (whole
  leaves gathered to the host), so either kind restores onto any
  mesh.  A step that holds params only (an
  import, a serving checkpoint) is refused for resume: a finetune
  starts from it with `--init-from` (`train.load_pretrained_params`).
- `AsyncCheckpointManager` takes the snapshot (host copies) on the
  caller's thread and writes on a background thread, with the
  reference's contract: bounded saves in flight, retries with backoff
  whose exhaustion is logged and never stops training, wait-on-exit;
  `max_to_keep` prunes older steps of this port's format only.
- Across hosts (a gang, parallel/distributed.py): every host holds the
  same bits under 'data', so host 0 alone writes (`save` returns False
  on the others, taking no snapshot; where a pipeline's stages span
  hosts, every host takes part in host 0's snapshot, sending the
  leaves of its stages, and host 0 still writes the one step of whole
  leaves) and `close` ends with a barrier,
  so that no host exits before host 0's writes are done.  The step to
  resume is host 0's newest (`restore_or_init`, `restore_sharded`,
  `AsyncCheckpointManager.latest_step`), broadcast to every host, which
  then reads that step: a step host 0 has not finished renaming into
  place is never read by another host.  A host of a pipeline across
  hosts reads the leaves of its own stages and the end blocks only
  (`train.load_train_step`), so such a step restores onto the same
  layout, onto any other mesh, and onto one process without hosts.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import torch

from skypilot_tpu_torch.chaos import injector as chaos_injector
from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.observability import events as events_lib
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.utils import safetensors_io

logger = logging.getLogger(__name__)

PARAMS_FILE = 'params.safetensors'
FORMAT = 'skypilot_tpu_torch.params'
OPTIMIZER_FILE = 'optimizer.safetensors'
OPTIMIZER_FORMAT = 'skypilot_tpu_torch.optimizer'
# Where the checkpoint bucket is mounted on cluster hosts, and the
# variable the job contract exports (skypilot_tpu/skylet/constants.py).
CHECKPOINT_PATH = '/checkpoint'
ENV_CHECKPOINT_DIR = 'SKYTPU_CHECKPOINT_DIR'
# The save instruments live with the flight recorder's.
CHECKPOINT_SAVE_BUCKETS = events_lib.CHECKPOINT_SAVE_BUCKETS
checkpoint_save_hist = events_lib.checkpoint_save_hist
checkpoint_blocked_counter = events_lib.checkpoint_blocked_counter
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


def _primary_step(directory: Optional[str]) -> Optional[int]:
    """`latest_step` as host 0 sees it, on every host (without a group,
    this host's); host 0's CheckpointFormatError raises on every host."""
    if not distributed.is_primary():
        step = distributed.broadcast_object(None)
    else:
        try:
            step = latest_step(directory)
        except CheckpointFormatError as e:
            distributed.broadcast_object(e)
            raise
        step = distributed.broadcast_object(step)
    if isinstance(step, CheckpointFormatError):
        raise step
    return step


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if _SEP in key:
            raise ValueError(f'tree key {key!r} holds {_SEP!r}')
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


Specs = Sequence[Tuple[Tuple[str, ...], torch.dtype, Sequence[int]]]


def _write_step(directory: str, step: int,
                files: Sequence[Tuple[str, Specs, Iterable[Tuple[
                    Tuple[str, ...], Any]], Dict[str, str]]],
                overwrite: bool) -> str:
    """Write step `step` as the files (name, specs, leaves, metadata),
    each through `safetensors_io.write_file`, under a temporary name
    that is renamed into place once every file is on disk."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    if os.path.exists(final) and not overwrite:
        raise ValueError(f'step {step} already exists under {directory}')
    tmp = tempfile.mkdtemp(prefix=f'.tmp-{step}-', dir=directory)
    try:
        for name, specs, leaves, metadata in files:
            path = os.path.join(tmp, name)
            safetensors_io.write_file(
                path, [(_SEP.join(p), dt, shape) for p, dt, shape in specs],
                ((_SEP.join(p), v) for p, v in leaves), metadata=metadata)
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


def save_leaves(directory: str, step: int, specs: Specs,
                leaves: Iterable[Tuple[Tuple[str, ...], Any]],
                overwrite: bool = False) -> str:
    """Write step `step` from leaves that `leaves` yields one at a time
    as (path, value) in the order of `specs` (path, dtype, shape); a
    value is a tensor or its slabs along axis 0
    (`safetensors_io.write_file`).  Atomic: written under a temporary
    name, then renamed.  An existing step is refused unless
    `overwrite`.  Returns the step's directory."""
    return _write_step(directory, step, [(
        PARAMS_FILE, specs, leaves,
        {'format': FORMAT, 'step': str(step)})], overwrite)


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
                   step: Optional[int] = None,
                   pieces: Optional[Callable[[Tuple[str, ...],
                                              Tuple[int, ...]],
                                             List[Tuple[Any, Any]]]] = None
                   ) -> Any:
    """The params tree of the newest step (or `step`) under
    `directory`, its leaves streamed one at a time onto `device`, each
    through `leaf_fn(path, tensor)` when given.  Without a checkpoint,
    warns and returns None, as the reference returns its template.

    With `pieces` (fn(path, shape) -> [(index, device)], as many pairs
    for every leaf: `convert.tensor_pieces`), each leaf is read piece by
    piece, the slice `index` of the stored leaf straight from the file
    onto its device, so no whole leaf reaches a device; returns one
    tree per piece (the tensor ranks' trees)."""
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
        trees: List[Dict[str, Any]] = []
        for name in reader.keys():
            path = tuple(name.split(_SEP))
            if pieces is None:
                leaves = [reader.get_tensor(name).to(dev)]
            else:
                stored = reader.get(name)
                leaves = [safetensors_io.to_torch(
                    stored[index], reader.dtype(name)).to(piece_dev)
                          for index, piece_dev in pieces(path, stored.shape)]
            while len(trees) < len(leaves):
                trees.append({})
            for tree, leaf in zip(trees, leaves):
                if leaf_fn is not None:
                    leaf = leaf_fn(path, leaf)
                node = tree
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = leaf
    finally:
        reader.close()
    logger.info('Restored params from step %d of %s', step, directory)
    return trees if pieces is not None else trees[0] if trees else {}


# ---------------------------------------------------- training checkpoints


def default_bucket_name(user_hash: str) -> str:
    return f'skytpu-checkpoints-{user_hash}'


def checkpoint_dir() -> Optional[str]:
    """The directory training code checkpoints into (None when the task
    was launched without the checkpoint contract)."""
    return os.environ.get(ENV_CHECKPOINT_DIR)


Leaves = List[Tuple[Tuple[str, ...], torch.Tensor]]


@dataclasses.dataclass
class TrainSnapshot:
    """A TrainState as host tensors of its own (`train.snapshot`):
    the f32 params and the AdamW moments by tree path, in the order of
    `convert.param_tree`, the optimizer's step count (its bias
    correction) and the TrainState's step."""
    params: Leaves
    mu: Leaves
    nu: Leaves
    count: int
    train_step: int


def save_train_step(directory: str, step: int, snapshot: TrainSnapshot,
                    overwrite: bool = True) -> str:
    """Write a training step (`params.safetensors` +
    `optimizer.safetensors`) atomically; -> its directory."""
    def specs(leaves, prefix=()):
        return [(prefix + p, t.dtype, tuple(t.shape)) for p, t in leaves]

    def tagged(leaves, prefix):
        return [(prefix + p, t) for p, t in leaves]

    meta = {'step': str(step), 'train_step': str(snapshot.train_step)}
    moments = tagged(snapshot.mu, ('mu',)) + tagged(snapshot.nu, ('nu',))
    return _write_step(directory, step, [
        (PARAMS_FILE, specs(snapshot.params), snapshot.params,
         {'format': FORMAT, **meta}),
        (OPTIMIZER_FILE, specs(moments), moments,
         {'format': OPTIMIZER_FORMAT, 'count': str(snapshot.count),
          **meta})], overwrite)


def _is_port_step(directory: str, step: int) -> bool:
    path = os.path.join(directory, str(step), PARAMS_FILE)
    if not os.path.isfile(path):
        return False
    try:
        reader = safetensors_io.SafetensorsFile(path)
    except (OSError, ValueError):
        return False
    try:
        return reader.metadata.get('format') == FORMAT
    finally:
        reader.close()


def prune_steps(directory: str, max_to_keep: int) -> List[int]:
    """Delete all but the newest `max_to_keep` steps of this port's
    format under `directory` (other step directories, an orbax step
    say, are left alone); -> the steps deleted."""
    ours = sorted(s for s in _steps(directory) if _is_port_step(directory, s))
    doomed = ours[:-max_to_keep] if max_to_keep > 0 else []
    for step in doomed:
        shutil.rmtree(os.path.join(directory, str(step)), ignore_errors=True)
    return doomed


def step_specs(directory: str, step: int) -> Dict[str, Tuple[str, Tuple[
        int, ...]]]:
    """{name: (safetensors dtype, shape)} of a step's params, read from
    the file's header alone."""
    reader = safetensors_io.SafetensorsFile(_step_file(directory, step))
    try:
        return {name: (reader.dtype(name), reader.shape(name))
                for name in reader.keys()}
    finally:
        reader.close()


def _load_step(state: Any, directory: str, step: int) -> Any:
    """Training step `step` under `directory` put into `state` in place
    (`train.load_train_step`: whole leaves read on the host, each
    parameter or block given its slice)."""
    from skypilot_tpu_torch.models import train as train_lib  # pylint: disable=import-outside-toplevel
    params_path = _step_file(directory, step)
    opt_path = os.path.join(directory, str(step), OPTIMIZER_FILE)
    if not os.path.isfile(opt_path):
        raise CheckpointFormatError(
            f'{os.path.dirname(params_path)} holds params only (an import '
            'or a serving checkpoint), not a training step to resume: '
            'start a finetune from it with --init-from '
            '(train.load_pretrained_params)')
    params = safetensors_io.SafetensorsFile(params_path)
    moments = safetensors_io.SafetensorsFile(opt_path)
    try:
        for reader, fmt in ((params, FORMAT), (moments, OPTIMIZER_FORMAT)):
            if reader.metadata.get('format') != fmt:
                raise CheckpointFormatError(
                    f'{reader.path}: format '
                    f'{reader.metadata.get("format")!r}, not {fmt!r}')
        train_lib.load_train_step(
            state, params, moments, count=int(moments.metadata['count']),
            train_step=int(moments.metadata['train_step']))
    finally:
        params.close()
        moments.close()
    return state


def restore_or_init(state: Any, directory: Optional[str] = None
                    ) -> Tuple[Any, int]:
    """(state, start_step): the newest training step under `directory`
    (default `checkpoint_dir()`) restored into `state` in place (every
    parameter, both moments, the optimizer's count and the step; a
    sharded state's blocks each get their slices), and start_step =
    saved step + 1; (state, 0) without a checkpoint.  The auto-resume
    convention: a relaunched task calls this and continues where the
    evicted run left off."""
    directory = directory or checkpoint_dir()
    step = _primary_step(directory)
    if step is None:
        return state, 0
    _load_step(state, directory, step)
    logger.info('Restored training step %d of %s', step, directory)
    return state, step + 1


def restore_sharded(directory: str, abstract_state: Any,
                    shardings: Dict[str, Any]) -> Tuple[Optional[Any], int]:
    """(state, start_step): the newest training step under `directory`
    put onto `shardings`, which may lie on another mesh (smaller or
    larger) than the one that saved it (the counterpart of the
    reference's orbax restore onto NamedShardings).  `abstract_state`
    and `shardings` come from `train.abstract_train_state`; the state is
    materialised with that layout (every copy of every block) and each
    block's owner filled from the whole leaves read on the host, then
    its other copies from the owner (`train.fill_copies`), so no device
    holds a full leaf that it does not keep.  (None, 0) when the
    directory holds no checkpoint."""
    from skypilot_tpu_torch.models import train as train_lib  # pylint: disable=import-outside-toplevel
    step = _primary_step(directory)
    if step is None:
        return None, 0
    state = _load_step(train_lib.materialize(abstract_state, shardings),
                       directory, step)
    mesh = next(iter(shardings.values())).mesh
    logger.info('Sharded-restored step %d of %s onto %d device(s)', step,
                directory, len(mesh.distinct_devices()))
    return state, step + 1


class AsyncCheckpointManager:
    """Checkpoint saves off the step's critical path (the reference's
    contract, `skypilot_tpu/data/checkpoints.py:230-436`).

    The step loop calls :meth:`save`; the device -> host snapshot is
    taken on the caller's thread (every leaf a host copy made before
    `save` returns: `train_step` updates the state in place, so a
    snapshot that aliased it would be torn by the next step), and the
    durable write runs on a background writer thread.

    - **Bounded in-flight saves**: at most `max_in_flight` snapshots are
      queued or being written; at the bound `save` blocks until a slot
      frees.  The blocked time accumulates in `blocked_seconds` and
      ``skytpu_checkpoint_blocked_seconds_total``: nonzero means the
      save interval is shorter than the write takes.
    - **Retry with backoff**: a failed write retries up to `max_retries`
      times with exponential backoff; exhaustion logs the error, counts
      `saves_failed` and training goes on.
    - **Wait-on-exit**: :meth:`wait_until_finished` / :meth:`close`
      drain every queued save.
    - Every save is timed into ``skytpu_checkpoint_save_seconds``, and
      journaled as ``checkpoint_save_start`` / ``_end`` (status,
      attempts, duration_s) to `journal`, by default the training
      journal (`events.training_journal()`, the flight recorder).  A
      write attempt is the ``checkpoint.save`` chaos site: an injected
      raise is a write flake that the retry loop retries.

    `async_save=False` writes on the caller's thread with the same
    retry semantics.
    """

    def __init__(self,
                 directory: Optional[str] = None,
                 *,
                 max_to_keep: int = 3,
                 save_interval_steps: int = 1,
                 max_in_flight: int = 1,
                 max_retries: int = 3,
                 retry_backoff_s: float = 0.1,
                 async_save: bool = True,
                 journal: Optional[Any] = None) -> None:
        directory = directory or checkpoint_dir()
        if directory is None:
            raise RuntimeError(
                'No checkpoint dir: set SKYTPU_CHECKPOINT_DIR or pass '
                'directory=.')
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = max(1, int(save_interval_steps))
        self.max_in_flight = max(1, int(max_in_flight))
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = retry_backoff_s
        self.async_save = async_save
        self._journal = (journal if journal is not None
                         else events_lib.training_journal())
        self._slots = threading.Semaphore(self.max_in_flight)
        # (step, snapshot, blocked seconds), or None to stop the writer.
        self._queue: queue.Queue = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._closed = False
        self.saves_ok = 0
        self.saves_failed = 0
        self.blocked_seconds = 0.0
        self.last_error: Optional[BaseException] = None
        self._writer: Optional[threading.Thread] = None
        if self.async_save:
            self._writer = threading.Thread(target=self._writer_loop,
                                            name='skytpu-ckpt-writer',
                                            daemon=True)
            self._writer.start()

    # ------------------------------------------------------------- public

    def save(self, step: int, state: Any) -> bool:
        """Snapshot `state` and schedule its durable write; -> whether a
        save was scheduled (False off the save interval, where no
        snapshot is taken)."""
        if self._closed:
            raise RuntimeError('AsyncCheckpointManager is closed')
        if step % self.save_interval_steps != 0:
            return False
        from skypilot_tpu_torch.models import train as train_lib  # pylint: disable=import-outside-toplevel
        snapshot = train_lib.save_snapshot(state)
        if snapshot is None:    # another host's: host 0 writes
            return False
        if not self.async_save:
            self._write(step, snapshot, blocked_s=0.0)
            return True
        t0 = time.monotonic()
        self._slots.acquire()  # bounded in-flight: block when full
        blocked_s = time.monotonic() - t0
        if blocked_s > 0.001:
            self.blocked_seconds += blocked_s
            checkpoint_blocked_counter().inc(blocked_s)
        with self._pending_lock:
            self._pending += 1
            self._idle.clear()
        self._queue.put((step, snapshot, blocked_s))
        return True

    def latest_step(self) -> Optional[int]:
        """The newest step as host 0 sees it, on every host."""
        return _primary_step(self.directory)

    def restore_or_init(self, state: Any) -> Tuple[Any, int]:
        """The module-level restore_or_init on this manager's
        directory."""
        return restore_or_init(state, self.directory)

    def wait_until_finished(self) -> None:
        """Block until every scheduled save has reached a terminal
        status (written, or failed after retries)."""
        if self.async_save:
            self._idle.wait()

    def close(self) -> None:
        """Drain and stop the writer (wait-on-exit), then wait for every
        host (a barrier across a gang)."""
        if self._closed:
            return
        self.wait_until_finished()
        self._closed = True
        if self._writer is not None:
            self._queue.put(None)
            self._writer.join(timeout=60)
        distributed.barrier()

    def __enter__(self) -> 'AsyncCheckpointManager':
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        del exc_type, exc, tb
        self.close()

    # ------------------------------------------------------------ internal

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            step, snapshot, blocked_s = item
            try:
                self._write(step, snapshot, blocked_s=blocked_s)
            finally:
                del snapshot, item    # the host copies go now
                self._slots.release()
                with self._pending_lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.set()

    def _write(self, step: int, snapshot: TrainSnapshot, *,
               blocked_s: float) -> None:
        self._journal.append('checkpoint_save_start', step=step,
                             directory=self.directory,
                             blocked_s=round(blocked_s, 6))
        t0 = time.monotonic()
        attempts = 0
        backoff = self.retry_backoff_s
        # 'interrupted' survives only when something that is not retried
        # (KeyboardInterrupt, a worker shutdown) escapes the loop.
        status = 'interrupted'
        try:
            while True:
                attempts += 1
                try:
                    chaos_injector.inject('checkpoint.save', step=step,
                                          attempt=attempts,
                                          directory=self.directory)
                    save_train_step(self.directory, step, snapshot)
                    prune_steps(self.directory, self.max_to_keep)
                    self.saves_ok += 1
                    status = 'ok'
                    break
                except Exception as e:  # pylint: disable=broad-except
                    if attempts > self.max_retries:
                        status = type(e).__name__
                        self.last_error = e
                        self.saves_failed += 1
                        logger.warning('checkpoint save at step %d failed '
                                       'after %d attempt(s): %s', step,
                                       attempts, e)
                        break
                    time.sleep(backoff)
                    backoff *= 2
        finally:
            duration = time.monotonic() - t0
            checkpoint_save_hist().observe(duration)
            self._journal.append('checkpoint_save_end', step=step,
                                 status=status, attempts=attempts,
                                 duration_s=round(duration, 6))
