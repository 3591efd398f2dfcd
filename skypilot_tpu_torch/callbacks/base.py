"""Step-timestamp logger of the training loop (a copy of
`skypilot_tpu/callbacks/base.py`): `init()` then `step()` (a context
manager) or `on_step_begin()` / `on_step_end()`; timestamps are
flushed to `<log_dir>/summary.json`, whose keys are the reference's,
so the bench harness reads either package's runs.

Training telemetry (observability/metrics.py): every step feeds the
process-global registry (steps, step-seconds histogram, tokens/s,
data-wait, peak memory), and `summary()` splits compute time from
data-wait: `seconds_per_step` (inter-end deltas, kept for
compatibility) folds data-loading gaps into step time, while
`compute_seconds_per_step` (begin -> end) and `data_wait_seconds`
(end -> next-begin gaps) report the two apart.  The hooks
`record_data_wait` / `record_peak_memory` are fed by data/prefetch.py
and models/train.py.

SKYTPU_JAX_PROFILE_DIR (the job contract's name) captures one
torch.profiler trace of the whole run (started at init(), written as
a Chrome trace at exit); never fatal, as in the reference.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from skypilot_tpu_torch.observability import metrics as metrics_lib

logger = logging.getLogger(__name__)

ENV_LOG_DIR = 'SKYTPU_BENCHMARK_LOG_DIR'
ENV_PROFILE_DIR = 'SKYTPU_JAX_PROFILE_DIR'
DEFAULT_LOG_DIR = '~/.skytpu/benchmark_logs'
SUMMARY_FILE = 'summary.json'

_M_STEPS = metrics_lib.counter(
    'skytpu_train_steps_total', 'Optimizer steps completed.')
_M_STEP_SECONDS = metrics_lib.histogram(
    'skytpu_train_step_seconds',
    'Wall seconds per step (on_step_begin -> on_step_end).',
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0, 60.0, 300.0))
_M_DATA_WAIT = metrics_lib.counter(
    'skytpu_train_data_wait_seconds_total',
    'Seconds the training loop blocked waiting for input batches.')
_M_TOKENS_PER_S = metrics_lib.gauge(
    'skytpu_train_tokens_per_s',
    'Training throughput over the steady-state steps '
    '(needs tokens_per_step).')
_M_PEAK_MEMORY = metrics_lib.gauge(
    'skytpu_train_peak_memory_bytes',
    'Peak bytes allocated on the device over the first training step '
    '(torch.cuda.max_memory_allocated).')

_instance: Optional['SkyTpuCallback'] = None


class SkyTpuCallback:

    def __init__(self, log_dir: Optional[str] = None,
                 total_steps: Optional[int] = None,
                 flush_every: int = 10,
                 tokens_per_step: Optional[int] = None) -> None:
        log_dir = log_dir or os.environ.get(ENV_LOG_DIR, DEFAULT_LOG_DIR)
        self.log_dir = os.path.expanduser(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.total_steps = total_steps
        self.tokens_per_step = tokens_per_step
        self.flush_every = flush_every
        self.start_time = time.time()
        self.step_begins: list = []
        self.step_ends: list = []
        self.prefetch_wait_seconds = 0.0   # fed by record_data_wait
        self.peak_memory_bytes: Optional[int] = None
        self._lock = threading.Lock()
        self._profiler: Any = None
        self._profile_dir: Optional[str] = None
        atexit.register(self.flush)
        self._maybe_start_profiler()

    def _maybe_start_profiler(self) -> None:
        """SKYTPU_JAX_PROFILE_DIR=<dir>: one torch.profiler trace for
        the whole run (CPU ops, and CUDA kernels where there is a card;
        open the Chrome trace in Perfetto); never fatal: a box whose
        profiler cannot start still trains."""
        profile_dir = os.environ.get(ENV_PROFILE_DIR)
        if not profile_dir:
            return
        try:
            import torch  # pylint: disable=import-outside-toplevel
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        except Exception as e:  # pylint: disable=broad-except
            logger.warning('skytpu callback: torch.profiler trace not '
                           'started (%s: %s)', type(e).__name__, e)
            return
        self._profiler = profiler
        self._profile_dir = os.path.expanduser(profile_dir)
        atexit.register(self.stop_profiler)

    def stop_profiler(self) -> Optional[str]:
        """Stop the run's trace and write it as
        `<SKYTPU_JAX_PROFILE_DIR>/trace-<pid>.json`; -> its path, or None
        when no trace ran or the write failed (logged, never raised)."""
        profiler, self._profiler = self._profiler, None
        if profiler is None:
            return None
        try:
            profiler.stop()
            os.makedirs(self._profile_dir, exist_ok=True)
            path = os.path.join(self._profile_dir,
                                f'trace-{os.getpid()}.json')
            profiler.export_chrome_trace(path)
            return path
        except Exception as e:  # pylint: disable=broad-except
            logger.warning('skytpu callback: torch.profiler trace not '
                           'written (%s: %s)', type(e).__name__, e)
            return None

    def on_step_begin(self) -> None:
        with self._lock:
            self.step_begins.append(time.time())

    def on_step_end(self) -> None:
        # Snapshot under the lock, write outside it: the summary file
        # write must never stall a concurrent on_step_begin.
        summary = None
        with self._lock:
            now = time.time()
            self.step_ends.append(now)
            n = len(self.step_ends)
            if len(self.step_begins) >= n:
                _M_STEP_SECONDS.observe(now - self.step_begins[n - 1])
            if n % self.flush_every == 0:
                summary = self.summary()
        if summary is not None:
            self._write_summary(summary)
        _M_STEPS.inc()
        if self.tokens_per_step:
            rate = self._tokens_per_s()
            if rate is not None:
                _M_TOKENS_PER_S.set(rate)

    def _tokens_per_s(self) -> Optional[float]:
        compute = self._compute_seconds_per_step()
        if compute is None or compute <= 0 or not self.tokens_per_step:
            return None
        return self.tokens_per_step / compute

    @contextlib.contextmanager
    def step(self):
        self.on_step_begin()
        try:
            yield
        finally:
            self.on_step_end()

    def _compute_seconds_per_step(self) -> Optional[float]:
        """Mean begin -> end duration over the steady-state steps (the
        first step, which builds kernels and warms the allocator, is
        left out when there are >= 2): step compute, data-loading gaps
        out."""
        n = min(len(self.step_begins), len(self.step_ends))
        durations = [self.step_ends[i] - self.step_begins[i]
                     for i in range(n)]
        if not durations:
            return None
        if len(durations) >= 2:
            durations = durations[1:]
        return sum(durations) / len(durations)

    def _data_wait_seconds(self) -> float:
        """Total end -> next-begin gap: time the loop spent outside a
        step (fetching batches, checkpointing, logging)."""
        n = min(len(self.step_begins), len(self.step_ends))
        return sum(max(0.0, self.step_begins[i] - self.step_ends[i - 1])
                   for i in range(1, n))

    def summary(self) -> Dict[str, Any]:
        steps = len(self.step_ends)
        elapsed = (self.step_ends[-1] - self.start_time) if steps else 0.0
        seconds_per_step = None
        if steps >= 2:
            # Steady state: the first step is left out.  Inter-end
            # deltas, data-wait gaps included (the reference's
            # definition); the split view is compute_seconds_per_step +
            # data_wait_seconds below.
            seconds_per_step = ((self.step_ends[-1] - self.step_ends[0]) /
                                (steps - 1))
        return {
            'start_time': self.start_time,
            'num_steps': steps,
            'elapsed_seconds': elapsed,
            'seconds_per_step': seconds_per_step,
            'compute_seconds_per_step': self._compute_seconds_per_step(),
            'data_wait_seconds': self._data_wait_seconds(),
            'prefetch_wait_seconds': self.prefetch_wait_seconds,
            'tokens_per_step': self.tokens_per_step,
            'tokens_per_s': self._tokens_per_s(),
            'peak_memory_bytes': self.peak_memory_bytes,
            'first_step_seconds':
                (self.step_ends[0] - self.start_time) if steps else None,
            'total_steps': self.total_steps,
            'last_step_time': self.step_ends[-1] if steps else None,
        }

    def flush(self) -> None:
        with self._lock:
            summary = self.summary()
        self._write_summary(summary)

    def _write_summary(self, summary: Dict[str, Any]) -> None:
        """File I/O only: callers snapshot state under the lock and
        write with it released, so flushes never block the step path."""
        path = os.path.join(self.log_dir, SUMMARY_FILE)
        tmp = path + '.tmp'
        with open(tmp, 'w', encoding='utf-8') as f:
            json.dump(summary, f)
        os.replace(tmp, path)


def init(log_dir: Optional[str] = None,
         total_steps: Optional[int] = None,
         tokens_per_step: Optional[int] = None) -> SkyTpuCallback:
    global _instance
    if _instance is None:
        _instance = SkyTpuCallback(log_dir=log_dir,
                                   total_steps=total_steps,
                                   tokens_per_step=tokens_per_step)
        return _instance
    # The singleton exists: a later caller's arguments must not vanish.
    # A different log_dir is an error (checked first, so a rejected
    # call leaves the singleton untouched), then total_steps and
    # tokens_per_step are adopted.
    if (log_dir is not None and
            os.path.expanduser(log_dir) != _instance.log_dir):
        raise RuntimeError(
            f'skytpu callback already initialized with log_dir='
            f'{_instance.log_dir!r}; cannot switch to {log_dir!r}.')
    if total_steps is not None:
        _instance.total_steps = total_steps
    if tokens_per_step is not None:
        _instance.tokens_per_step = tokens_per_step
    return _instance


def reset() -> None:
    """Flush and drop the singleton (and stop its trace), so that the
    next `init()` starts a summary of its own: for a process that runs
    several trainings one after another."""
    global _instance
    cb, _instance = _instance, None
    if cb is None:
        return
    cb.stop_profiler()
    cb.flush()
    atexit.unregister(cb.flush)
    atexit.unregister(cb.stop_profiler)


def _require() -> SkyTpuCallback:
    if _instance is None:
        raise RuntimeError('call skytpu_callback init() first')
    return _instance


def on_step_begin() -> None:
    _require().on_step_begin()


def on_step_end() -> None:
    _require().on_step_end()


def step():
    return _require().step()


# ------------------------------------------------------------- hooks
# Fed by data/prefetch.py and models/train.py; safe to call whether or
# not init() ran (the registry metric always updates, the summary
# field only with a live singleton).


def record_data_wait(seconds: float) -> None:
    """The consumer blocked `seconds` waiting for an input batch
    (DevicePrefetcher reports its queue-get block time here)."""
    if seconds <= 0:
        return
    _M_DATA_WAIT.inc(seconds)
    if _instance is not None:
        _instance.prefetch_wait_seconds += seconds


def record_peak_memory(nbytes: int) -> None:
    """The training step's peak device allocation
    (models/train.py::peak_memory_bytes feeds this)."""
    _M_PEAK_MEMORY.set(nbytes)
    if _instance is not None:
        _instance.peak_memory_bytes = int(nbytes)
