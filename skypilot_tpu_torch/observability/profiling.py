"""Continuous profiling plane: tick-phase breakdown + shape sentinel for
the serving engine (the port of `skypilot_tpu/observability/profiling.py`:
the same names, phase vocabulary, snapshot keys and metric names).

Two always-on, low-overhead instruments:

- **TickProfiler** — a bounded ring of per-tick phase timings.  The
  engine worker marks phase boundaries with `lap()`; each lap is ONE
  host clock read (the previous lap's timestamp is the phase start, so
  phases are exclusive by construction — nested laps, like the
  page-scatter inside a prefill finish, subtract themselves from the
  enclosing phase).  Idle ticks (no recorded phase) never enter the
  ring.  Each retained tick carries a device-memory watermark when the
  engine gives a memory callback (`device_memory_cb`: the CUDA
  allocator's peak for a CUDA engine, None on the CPU).  Phase
  durations also feed the process-global
  `skytpu_engine_tick_phase_seconds{phase}` histogram.

  Laps are host-clock laps, as on the TPU: the profiler never touches
  the device (no profiler hooks, no events, no synchronisation).  The
  tick's one host sync happens in the engine; the lap that follows it
  carries the wait for the device.

- **RecompileSentinel** — wraps the engine's step entries and watches
  each call's input signature (dtype and shape of every tensor
  argument).  The reference probes jax's jit cache; the port has none,
  so the signature set is the whole test: a new signature is a
  "compile".  On CUDA a new signature means a new prefill or chunk
  width, or a new page-write shape, and with it new cuBLAS and kernel
  choices.  A decode or spec tick's row bucket is chosen inside the
  step from slots x (k+1), and the step's arguments (config, model,
  state, cache) keep their shapes for the engine's whole life, so the
  step has one signature and the sentinel does not see row buckets.
  New signatures during warm-up are expected; one after `steady_after` quiet calls bumps
  `skytpu_engine_recompiles_total{fn}` (the reference's name, which the
  fleet reads) and journals `recompile_detected` to the serving
  journal (`serve_journal`, `<journal_root>/serve.jsonl`), where the
  engine's `tick_profile_start` / `_end` pair, one a worker's run, lands
  too.

Knobs: `SKYTPU_PROFILE_RING_TICKS` (ring capacity, default 512),
`SKYTPU_PROFILE_DISABLE` (=1 turns both instruments into no-ops).
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.observability import events as events_lib
from skypilot_tpu_torch.observability import metrics as metrics_lib

# The complete tick-phase vocabulary.  A tick records only the phases
# that ran; decode-step and spec-verify are mutually exclusive per tick,
# slice-sync appears only on multi-host replicas.
PHASES = ('admit', 'prefill-chunk', 'decode-step', 'spec-verify',
          'sample', 'page-scatter', 'handoff', 'slice-sync')

DEFAULT_RING_TICKS = 512
# Steady-state threshold: a new signature after this many quiet calls
# of the same entry is a regression signal, not warm-up.
DEFAULT_STEADY_AFTER = 64
# Leaves of a call's signature kept in the snapshot and the journal.
SIGNATURE_LEAVES = 16

_M_PHASE = metrics_lib.histogram(
    'skytpu_engine_tick_phase_seconds',
    'Engine tick time by phase (exclusive: phases of one tick sum to '
    'the tick duration).',
    ('phase',),
    buckets=(50e-6, 200e-6, 1e-3, 5e-3, 20e-3, 0.1, 0.5))
_M_RECOMPILES = metrics_lib.counter(
    'skytpu_engine_recompiles_total',
    'Steady-state recompilations detected per step entry (in the port: '
    'a new input signature, i.e. a new prefill width or page-write '
    'shape, after the warm-up window).',
    ('fn',))
# Pre-bound histogram children: .labels() validates and rebuilds the
# label tuple on every call, which is most of the per-lap cost — the
# phase vocabulary is closed, so bind once.
_PHASE_OBSERVERS = {name: _M_PHASE.labels(phase=name)
                    for name in PHASES}


def profiling_disabled() -> bool:
    return bool(os.environ.get('SKYTPU_PROFILE_DISABLE'))


def ring_ticks_default() -> int:
    raw = os.environ.get('SKYTPU_PROFILE_RING_TICKS')
    try:
        n = int(raw) if raw else DEFAULT_RING_TICKS
    except ValueError:
        n = DEFAULT_RING_TICKS
    return max(1, n)


def serve_journal() -> events_lib.EventJournal:
    """The serving flight recorder (`<journal_root>/serve.jsonl`):
    recompile detections and the tick_profile lifecycle land next to the
    page alloc/free, request and weight-swap events."""
    return events_lib.get_journal(
        os.path.join(events_lib.journal_root(), 'serve.jsonl'))


def _no_memory() -> Optional[int]:
    return None


def device_memory_cb(device: torch.device
                     ) -> Callable[[], Optional[int]]:
    """The memory callback of an engine on `device`: the CUDA
    allocator's peak bytes (host-side counters, no device sync), or
    None on the CPU, as the reference's CPU backend reports."""
    if device.type != 'cuda':
        return _no_memory
    return lambda: int(torch.cuda.max_memory_allocated(device))


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class TickProfiler:
    """Per-tick phase timings in a bounded ring.

    Single-writer (the engine worker thread) / multi-reader
    (`snapshot()` from HTTP threads): the in-progress tick is thread
    local to the writer; only the ring append and aggregate updates
    take the lock.
    """

    def __init__(self, *, ring_ticks: Optional[int] = None,
                 disabled: Optional[bool] = None,
                 memory_cb: Optional[Callable[[], Optional[int]]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.disabled = (profiling_disabled() if disabled is None
                         else bool(disabled))
        self.ring_ticks = (ring_ticks_default() if ring_ticks is None
                           else max(1, int(ring_ticks)))
        self._clock = clock
        self._memory_cb = _no_memory if memory_cb is None else memory_cb
        self._mem_dead = False   # backend reported nothing; stop asking
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.ring_ticks)
        self._ticks = 0          # non-idle ticks retained (cumulative)
        self._laps = 0           # recorded laps (cumulative)
        self._phase_totals: Dict[str, float] = {}
        self._phase_counts: Dict[str, int] = {}
        self._mem_watermark: Optional[int] = None
        # Worker-thread state for the in-progress tick.
        self._t_tick0 = 0.0
        self._t_last = 0.0
        self._cur: List[Tuple[str, float, float]] = []
        # Self-overhead model: per-lap clock+bookkeeping cost measured
        # once, multiplied by the cumulative lap count in snapshot().
        self._per_lap_s = self._calibrate(clock)

    @staticmethod
    def _calibrate(clock: Callable[[], float]) -> float:
        n = 256
        t0 = time.perf_counter()
        for _ in range(n):
            clock()
        per_read = (time.perf_counter() - t0) / n
        # A lap is one clock read plus a tuple append; double the read
        # cost is a deliberately pessimistic bound.
        return per_read * 2.0

    # ---------------------------------------------- worker-thread API

    def begin_tick(self) -> None:
        if self.disabled:
            return
        now = self._clock()
        self._t_tick0 = now
        self._t_last = now
        self._cur = []

    def lap(self, phase: str, record: bool = True) -> None:
        """Close the interval since the previous lap.  `record=False`
        advances the lap clock without attributing the interval (the
        phase's machinery ran but did no work this tick)."""
        if self.disabled:
            return
        now = self._clock()
        if record:
            self._cur.append((phase, self._t_last - self._t_tick0,
                              now - self._t_last))
        self._t_last = now

    def end_tick(self) -> None:
        """Retain the tick if any phase recorded; idle spins of the
        worker loop never enter the ring."""
        if self.disabled:
            return
        cur = self._cur
        self._cur = []
        if not cur:
            return
        mem = self._sample_mem()
        rec = {
            'ts': time.time(),
            'dur_s': self._t_last - self._t_tick0,
            'phases': cur,
            'mem_bytes': mem,
        }
        with self._lock:
            self._ring.append(rec)
            self._ticks += 1
            self._laps += len(cur)
            for name, _, dur in cur:
                self._phase_totals[name] = (
                    self._phase_totals.get(name, 0.0) + dur)
                self._phase_counts[name] = (
                    self._phase_counts.get(name, 0) + 1)
            if mem is not None and (self._mem_watermark is None or
                                    mem > self._mem_watermark):
                self._mem_watermark = mem
        for name, _, dur in cur:
            obs = _PHASE_OBSERVERS.get(name)
            if obs is None:
                obs = _M_PHASE.labels(phase=name)
            obs.observe(dur)

    def _sample_mem(self) -> Optional[int]:
        if self._mem_dead:
            return None
        mem = self._memory_cb()
        if mem is None:
            self._mem_dead = True
        return mem

    # ------------------------------------------------- reader-side API

    @property
    def ticks(self) -> int:
        with self._lock:
            return self._ticks

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view: ring, per-phase aggregates + quantiles over
        the ring, memory watermark, and the profiler's own modeled
        overhead."""
        with self._lock:
            ring = [dict(rec, phases=[list(p) for p in rec['phases']])
                    for rec in self._ring]
            totals = dict(self._phase_totals)
            counts = dict(self._phase_counts)
            ticks = self._ticks
            laps = self._laps
            watermark = self._mem_watermark
        durs_by_phase: Dict[str, List[float]] = {}
        for rec in ring:
            for name, _, dur in rec['phases']:
                durs_by_phase.setdefault(name, []).append(dur)
        phases: Dict[str, Dict[str, Any]] = {}
        for name, total in sorted(totals.items()):
            durs = sorted(durs_by_phase.get(name, ()))
            phases[name] = {
                'count': counts.get(name, 0),
                'total_s': total,
                'p50_s': _quantile(durs, 0.5),
                'p90_s': _quantile(durs, 0.9),
                'p99_s': _quantile(durs, 0.99),
                'max_s': durs[-1] if durs else None,
            }
        last_mem = next((rec['mem_bytes'] for rec in reversed(ring)
                         if rec.get('mem_bytes') is not None), None)
        return {
            'enabled': not self.disabled,
            'ring_ticks': self.ring_ticks,
            'ticks': ticks,
            'phases': phases,
            'ring': ring,
            'device_memory': {'watermark_bytes': watermark,
                              'last_bytes': last_mem},
            'overhead_s': laps * self._per_lap_s,
        }


def _leaves(obj, out: List[Any]) -> None:
    """Flatten dicts (sorted keys), lists and tuples; anything else,
    an nn.Module included, is one leaf."""
    if isinstance(obj, dict):
        for key in sorted(obj, key=str):
            _leaves(obj[key], out)
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            _leaves(item, out)
    else:
        out.append(obj)


class RecompileSentinel:
    """Counts new input signatures per wrapped step entry and flags the
    steady-state ones (a new signature after `steady_after` quiet
    calls)."""

    def __init__(self, *, steady_after: int = DEFAULT_STEADY_AFTER,
                 journal_factory: Optional[Callable[[], Any]] = None,
                 disabled: Optional[bool] = None) -> None:
        self.disabled = (profiling_disabled() if disabled is None
                         else bool(disabled))
        self.steady_after = int(steady_after)
        self._journal_factory = (serve_journal if journal_factory is None
                                 else journal_factory)
        self._lock = threading.Lock()
        self._fns: Dict[str, Dict[str, Any]] = {}

    def wrap(self, name: str, fn):
        """Pass-through wrapper: after every call, the call's signature
        (dtype and shape of its tensor arguments, read on the host)
        decides whether it was new."""
        if self.disabled or fn is None:
            return fn
        with self._lock:
            self._fns.setdefault(name, {
                'calls': 0, 'compiles': 0, 'steady_recompiles': 0,
                'quiet_calls': 0, 'signatures': {},
            })

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            self._after_call(name, args)
            return out

        wrapped.__name__ = name
        wrapped.__wrapped__ = fn
        return wrapped

    @staticmethod
    def _signature(args, limit: int = SIGNATURE_LEAVES) -> str:
        """Compact abstract signature of a call's positional args:
        dtype[shape] per tensor leaf, the type name of any other leaf,
        capped so a cache dict does not explode the line."""
        leaves: List[Any] = []
        _leaves(args, leaves)
        parts: List[str] = []
        for leaf in leaves:
            shape = getattr(leaf, 'shape', None)
            if shape is not None:
                dtype = getattr(leaf, 'dtype', '?')
                dims = ','.join(str(d) for d in shape)
                parts.append(f'{dtype}[{dims}]')
            else:
                parts.append(type(leaf).__name__)
        if len(parts) > limit:
            parts = parts[:limit] + [f'...+{len(parts) - limit} leaves']
        return '(' + ', '.join(parts) + ')'

    def _after_call(self, name: str, args) -> None:
        sig = self._signature(args)
        steady_hit = None
        with self._lock:
            st = self._fns[name]
            st['calls'] += 1
            if sig not in st['signatures']:
                st['compiles'] += 1
                st['signatures'][sig] = 1
                quiet = st['quiet_calls']
                st['quiet_calls'] = 0
                if quiet >= self.steady_after:
                    st['steady_recompiles'] += 1
                    steady_hit = quiet
            else:
                st['quiet_calls'] += 1
        if steady_hit is None:
            return
        _M_RECOMPILES.labels(fn=name).inc()
        try:
            journal = self._journal_factory()
        except Exception:  # pylint: disable=broad-except
            journal = None
        if journal is not None:
            journal.append('recompile_detected', fn=name, shapes=sig,
                           quiet_calls=steady_hit)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {}
            for name, st in sorted(self._fns.items()):
                sigs = dict(list(st['signatures'].items())[:8])
                out[name] = {
                    'calls': st['calls'],
                    'compiles': st['compiles'],
                    'steady_recompiles': st['steady_recompiles'],
                    'signatures': sigs,
                }
        out_total = sum(v['steady_recompiles'] for v in out.values())
        return {'fns': out, 'steady_recompiles_total': out_total,
                'steady_after': self.steady_after,
                'enabled': not self.disabled}


# --------------------------------------------------------------- exports

def collapsed_stacks(snapshot: Dict[str, Any],
                     root: str = 'engine') -> str:
    """Brendan-Gregg collapsed-stack lines (`engine;phase count_us`)
    from a profiler snapshot — pipe into any flamegraph tool."""
    lines = []
    for name, agg in sorted(snapshot.get('phases', {}).items()):
        us = int(round(float(agg.get('total_s') or 0.0) * 1e6))
        lines.append(f'{root};{name} {us}')
    return '\n'.join(lines) + ('\n' if lines else '')


def chrome_trace(snapshot: Dict[str, Any], *, pid: int = 0,
                 tid: int = 0) -> Dict[str, Any]:
    """Chrome trace-event JSON (`chrome://tracing` / Perfetto) from a
    profiler snapshot's ring: one complete ('X') event per recorded
    phase, plus a device-memory counter track when watermarks exist."""
    events: List[Dict[str, Any]] = []
    for rec in snapshot.get('ring', ()):
        base_us = float(rec.get('ts', 0.0)) * 1e6
        for entry in rec.get('phases', ()):
            name, rel, dur = entry[0], float(entry[1]), float(entry[2])
            events.append({
                'name': name, 'cat': 'engine-tick', 'ph': 'X',
                'ts': base_us + rel * 1e6,
                'dur': max(dur * 1e6, 0.01),
                'pid': pid, 'tid': tid, 'args': {},
            })
        mem = rec.get('mem_bytes')
        if mem is not None:
            events.append({
                'name': 'device_memory', 'cat': 'engine-tick',
                'ph': 'C', 'ts': base_us, 'pid': pid, 'tid': tid,
                'args': {'bytes_in_use': int(mem)},
            })
    return {'traceEvents': events, 'displayTimeUnit': 'ms'}
