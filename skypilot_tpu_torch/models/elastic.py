"""Elastic training: gang resizes without losing progress (mirrors
`skypilot_tpu/models/elastic.py`).

When a partial preemption takes some of a job's devices, the survivors
keep training instead of idling through a teardown and relaunch:

1. the checkpointer is closed, so no save in flight is abandoned;
2. the resize is journaled ``gang_resize{from,to,direction,reason}``
   and counted in ``skytpu_gang_resizes_total{direction}``;
3. the mesh is rebuilt over the new devices with the batch axes
   re-inferred (`parallel.mesh.elastic_mesh_config`: data and fsdp
   rescale, the model axes never change);
4. the newest checkpoint is restored onto the new mesh's layout
   (`checkpoints.restore_sharded` over `train.abstract_train_state`),
   or, with none, a fresh state is made;
5. the resume is journaled ``train_resume{step,devices,mesh,restored}``.

When capacity returns, a later resize expands the same way.  Any steps
after the newest checkpoint are computed again: a resize trades at
most one save interval of work for keeping the job alive.  The journal
(`events.training_journal()` by default) is the reference's format, so
its invariant checkers (`resize_monotone_steps`, `checkpoint_liveness`)
replay it.

Devices are a list of mesh entries (parallel/mesh.py), default every
visible CUDA device (raising without one); an entry repeated on one
card keeps one copy of each block.  Inside a gang of hosts
(parallel/distributed.py) the trainer builds this host's part of the
global mesh and each host passes its own devices; an in-process
resize there raises (ROADMAP item A17c-ii): a smaller gang is a
relaunch whose trainers restore the newest checkpoint.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import train as train_lib
from skypilot_tpu_torch.observability import events as events_lib
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger(__name__)


class ElasticTrainer:
    """Train steps over a resizable device mesh with async checkpoints.

    The trainer owns the mesh (rebuilt on resize), the train state
    (restored onto each new mesh from the newest checkpoint), the step
    function and an `AsyncCheckpointManager`, closed before every
    resize.
    """

    def __init__(self,
                 cfg: Any,
                 tcfg: Optional[train_lib.TrainConfig] = None,
                 *,
                 checkpoint_dir: str,
                 mesh_config: Optional[mesh_lib.MeshConfig] = None,
                 batch_size: int = 8,
                 seq_len: int = 64,
                 devices: Optional[Sequence[Any]] = None,
                 save_interval_steps: int = 2,
                 max_in_flight: int = 1,
                 async_save: bool = True,
                 max_retries: int = 3,
                 retry_backoff_s: float = 0.05,
                 journal: Optional[Any] = None) -> None:
        self.cfg = cfg
        self.tcfg = tcfg or train_lib.TrainConfig()
        self.checkpoint_dir = checkpoint_dir
        self.mesh_config = mesh_config or mesh_lib.MeshConfig(data=1,
                                                              fsdp=-1)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.save_interval_steps = save_interval_steps
        self.max_in_flight = max_in_flight
        self.async_save = async_save
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self._journal = (journal if journal is not None
                         else events_lib.training_journal())
        self.devices = (list(devices) if devices is not None
                        else mesh_lib.default_devices())
        self.mesh: Optional[mesh_lib.Mesh] = None
        self.state: Optional[train_lib.TrainState] = None
        self.shardings: Optional[dict] = None
        self.step = 0
        self.resumed_from_checkpoint = False
        self._step_fn: Optional[Callable] = None
        self._ckpt: Optional[checkpoints.AsyncCheckpointManager] = None
        self._setup(self.devices)

    # ------------------------------------------------------------- setup

    def _global_devices(self, devices: Sequence[Any]) -> int:
        """Devices of the whole gang when every host passes as many."""
        return len(devices) * distributed.gang()[0]

    def _setup(self, devices: Sequence[Any]) -> None:
        self.devices = list(devices)
        cfgm = mesh_lib.elastic_mesh_config(
            self.mesh_config, self._global_devices(self.devices))
        self.mesh = mesh_lib.build_mesh(cfgm, devices=self.devices)
        abstract, shardings = train_lib.abstract_train_state(
            self.cfg, self.tcfg, mesh=self.mesh)
        state, start_step = checkpoints.restore_sharded(
            self.checkpoint_dir, abstract, shardings)
        self.resumed_from_checkpoint = state is not None
        if state is None:
            state, shardings = train_lib.create_train_state(
                self.cfg, self.tcfg, mesh=self.mesh)
            start_step = 0
        self.state = state
        self.shardings = shardings
        self.step = start_step
        self._step_fn = train_lib.make_train_step(self.tcfg)
        self._ckpt = checkpoints.AsyncCheckpointManager(
            self.checkpoint_dir,
            save_interval_steps=self.save_interval_steps,
            max_in_flight=self.max_in_flight,
            async_save=self.async_save,
            max_retries=self.max_retries,
            retry_backoff_s=self.retry_backoff_s,
            journal=self._journal)
        shape = self.mesh.global_shape
        self._journal.append('train_resume', step=start_step,
                             devices=self._global_devices(self.devices),
                             mesh=shape,
                             restored=self.resumed_from_checkpoint)
        logger.info('elastic trainer: step %d, %d device(s), mesh %s, '
                    'restored=%s', start_step,
                    self._global_devices(self.devices), shape,
                    self.resumed_from_checkpoint)

    # ----------------------------------------------------------- training

    def default_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The step's batch, a pure function of the step number (numpy's
        generator seeded with it), not of the mesh size or the host
        count: {'tokens': [batch_size, seq_len + 1] int32} on the host,
        this host's rows of it inside a gang."""
        rng = np.random.default_rng(step)
        tokens = rng.integers(0, self.cfg.vocab_size,
                              (self.batch_size, self.seq_len + 1),
                              dtype=np.int32)
        hosts, rank = distributed.gang()
        rows = self.batch_size // hosts
        return {'tokens': torch.from_numpy(
            tokens[rank * rows:(rank + 1) * rows])}

    def train_steps(self, num_steps: int,
                    batch_fn: Optional[Callable[[int], Dict[str, Any]]]
                    = None,
                    step_sleep_s: float = 0.0
                    ) -> List[Tuple[int, float]]:
        """`num_steps` optimizer steps from the current step ->
        [(step, loss)].  Each step's state is offered to the
        checkpointer, which saves on its interval off the step's
        critical path (beyond the bounded in-flight slot)."""
        batch_fn = batch_fn or self.default_batch
        losses: List[Tuple[int, float]] = []
        for _ in range(num_steps):
            step = self.step
            batch = batch_fn(step)
            self.state, metrics = self._step_fn(self.state, batch)
            loss = float(metrics['loss'])
            losses.append((step, loss))
            self.step = step + 1
            self._ckpt.save(step, self.state)
            if step_sleep_s:
                time.sleep(step_sleep_s)
        return losses

    # ------------------------------------------------------------- resize

    def resize(self, devices: Sequence[Any], reason: str = '') -> None:
        """Shrink or expand to `devices`: drain the saves in flight,
        journal ``gang_resize{from,to}``, rebuild the mesh with the batch
        axes re-inferred and restore the newest checkpoint onto it."""
        hosts = distributed.gang()[0]
        if hosts > 1:
            raise NotImplementedError(
                f'an in-process resize inside a group of {hosts} hosts: '
                'the group would have to be re-formed around the '
                'survivors; relaunch the smaller gang instead (each '
                'host\'s trainer restores the newest checkpoint).  '
                'ROADMAP item A17c-ii, a later slice of the port')
        old = self._global_devices(self.devices)
        new = self._global_devices(devices)
        self._ckpt.close()
        direction = 'shrink' if new < old else 'expand'
        events_lib.gang_resizes().labels(direction=direction).inc()
        self._journal.append('gang_resize', **{'from': old, 'to': new},
                             direction=direction, reason=reason or None)
        logger.info('elastic resize (%s): %d -> %d device(s)', direction,
                    old, new)
        # The old state goes before the new one is made: the two are
        # never on the devices at once.
        self.state = self.shardings = None
        self._setup(devices)

    # -------------------------------------------------------------- misc

    @property
    def checkpointer(self) -> checkpoints.AsyncCheckpointManager:
        return self._ckpt

    def close(self) -> None:
        """Drain the queued saves before returning."""
        if self._ckpt is not None:
            self._ckpt.close()
