"""The process-global fault injector (a copy of
`skypilot_tpu/chaos/injector.py`): `inject(site, **ctx)` hooks.

Code at a registered site calls ``inject('<site>', **ctx)``.  With no
plan armed it returns None after one module-global read and one
environment lookup; with a plan armed the call may raise a typed error,
sleep, or return the :data:`DENY` sentinel, per the plan's triggers.

Arming: :func:`arm` / :func:`disarm` programmatically (tests), or
``SKYTPU_CHAOS_PLAN`` in the environment, read on every call while
nothing is armed by hand, so a process started under the variable arms
itself.  A parsed plan is cached per value; a malformed value logs one
warning and behaves as no plan.

Every fired fault is journaled as ``chaos_fault_injected{site,effect}``
in ``$SKYTPU_HOME/events/chaos.jsonl`` (`chaos_journal`) and counted in
``skytpu_chaos_faults_total{site,effect}``.
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from skypilot_tpu_torch.chaos import faults as faults_lib
from skypilot_tpu_torch.observability import events as events_lib
from skypilot_tpu_torch.observability import metrics

logger = logging.getLogger(__name__)

# Returned by `inject` when a 'deny' fault fires; a cooperative site
# reports its operation as refused.
DENY = object()

_SCALAR_TYPES = (str, int, float, bool)


class ArmedPlan:
    """One armed plan: per-site call counters and per-fault state."""

    def __init__(self, plan: faults_lib.FaultPlan) -> None:
        self.plan = plan
        self.armed_at = time.monotonic()
        self._lock = threading.Lock()
        self._site_calls: Dict[str, int] = {}
        self._fired_counts: Dict[int, int] = {}
        # A generator per fault keyed off (seed, fault index): draws stay
        # deterministic however faults interleave across sites.
        self._rngs = [random.Random(f'{plan.seed}:{i}')
                      for i in range(len(plan.faults))]
        self.fault_log: List[Dict[str, Any]] = []

    def fire(self, site: str, ctx: Dict[str, Any]) -> Optional[object]:
        """Count the call; fire the first matching fault, if any."""
        if site not in faults_lib.SITES:
            raise ValueError(f'inject() called with unregistered site '
                             f'{site!r}; add it to chaos/faults.py SITES')
        with self._lock:
            call_no = self._site_calls.get(site, 0) + 1
            self._site_calls[site] = call_no
            elapsed = time.monotonic() - self.armed_at
            fault = None
            fault_idx = -1
            for idx, candidate in enumerate(self.plan.faults):
                if candidate.site != site:
                    continue
                if not candidate.matches_ctx(ctx):
                    continue
                if elapsed < candidate.after_s:
                    continue
                if (candidate.until_s is not None and
                        elapsed > candidate.until_s):
                    continue
                if (candidate.max_times is not None and
                        self._fired_counts.get(idx, 0) >=
                        candidate.max_times):
                    continue
                if candidate.nth is not None:
                    if call_no not in candidate.nth:
                        continue
                elif candidate.every is not None:
                    if call_no % candidate.every != 0:
                        continue
                elif candidate.probability is not None:
                    if self._rngs[idx].random() >= candidate.probability:
                        continue
                fault = candidate
                fault_idx = idx
                break
            if fault is None:
                return None
            self._fired_counts[fault_idx] = (
                self._fired_counts.get(fault_idx, 0) + 1)
            record = {
                'n': len(self.fault_log) + 1,
                'site': site,
                'effect': fault.effect,
                'fault_index': fault_idx,
                'call': call_no,
                'ctx': {k: v for k, v in sorted(ctx.items())
                        if isinstance(v, _SCALAR_TYPES)},
            }
            self.fault_log.append(record)
        self._record(record, fault)
        return self._apply(fault)

    # Journal-record field names ctx keys must not shadow.
    _RESERVED_FIELDS = frozenset(
        {'ts', 'seq', 'event', 'site', 'effect', 'call', 'error'})

    def _record(self, record: Dict[str, Any],
                fault: faults_lib.Fault) -> None:
        chaos_faults_total().labels(site=record['site'],
                                    effect=record['effect']).inc()
        ctx_fields = {
            (k if k not in self._RESERVED_FIELDS else f'ctx_{k}'): v
            for k, v in record['ctx'].items()
        }
        try:
            chaos_journal().append('chaos_fault_injected',
                                   site=record['site'],
                                   effect=record['effect'],
                                   call=record['call'],
                                   error=(fault.error
                                          if fault.effect in ('raise',
                                                              'preempt',
                                                              'hang')
                                          else None),
                                   **ctx_fields)
        except Exception:  # pylint: disable=broad-except
            pass  # the recorder must never mask the fault itself

    @staticmethod
    def _apply(fault: faults_lib.Fault) -> Optional[object]:
        # Sleeps happen outside the lock: a hanging site must not block
        # other threads' injections.
        if fault.effect == 'delay':
            time.sleep(fault.delay_s)
            return None
        if fault.effect == 'hang':
            time.sleep(fault.deadline_s)
            raise fault.make_error()
        if fault.effect == 'deny':
            return DENY
        if fault.effect == 'preempt':
            # The reference evicts the cluster its context names; the
            # port's sites carry none, and it has no cluster to evict.
            logger.warning('chaos preempt at %s: no cluster to evict',
                           fault.site)
        raise fault.make_error()


# ------------------------------------------------------------- module state

_armed: Optional[ArmedPlan] = None
_arm_lock = threading.Lock()
# Parsed-env cache: (env value, ArmedPlan or None if malformed).
_env_cache: Optional[Tuple[str, Optional[ArmedPlan]]] = None


def arm(plan: faults_lib.FaultPlan) -> ArmedPlan:
    """Arm a plan programmatically (overrides the env var)."""
    global _armed
    with _arm_lock:
        _armed = ArmedPlan(plan)
        return _armed


def disarm() -> None:
    """Disarm and drop any cached env-parsed plan."""
    global _armed, _env_cache
    with _arm_lock:
        _armed = None
        _env_cache = None


def current() -> Optional[ArmedPlan]:
    """The armed plan, if any: programmatic first, then env."""
    armed = _armed
    if armed is not None:
        return armed
    value = os.environ.get(faults_lib.PLAN_ENV_VAR)
    if not value:
        return None
    return _arm_from_env(value)


def _arm_from_env(value: str) -> Optional[ArmedPlan]:
    global _env_cache
    with _arm_lock:
        if _env_cache is not None and _env_cache[0] == value:
            return _env_cache[1]
        try:
            armed: Optional[ArmedPlan] = ArmedPlan(
                faults_lib.FaultPlan.from_env_value(value))
        except (ValueError, OSError, TypeError) as e:
            logger.warning('Ignoring malformed %s: %s',
                           faults_lib.PLAN_ENV_VAR, e)
            armed = None
        _env_cache = (value, armed)
        return armed


def is_armed() -> bool:
    return current() is not None


def site_armed(site: str) -> bool:
    """True iff the armed plan (if any) has a fault targeting `site`."""
    armed = current()
    return armed is not None and any(f.site == site
                                     for f in armed.plan.faults)


def inject(site: str, **ctx: Any) -> Optional[object]:
    """The hook instrumented code calls.  No plan armed -> None.  May
    raise a typed error, sleep, or return :data:`DENY`."""
    armed = current()
    if armed is None:
        return None
    return armed.fire(site, ctx)


def fault_log() -> List[Dict[str, Any]]:
    """This process's fired-fault sequence (empty when nothing armed)."""
    armed = current()
    return list(armed.fault_log) if armed is not None else []


# --------------------------------------------------------------- recording


def chaos_journal() -> events_lib.EventJournal:
    """The journal of every injected fault under this SKYTPU_HOME."""
    return events_lib.get_journal(
        os.path.join(events_lib.journal_root(), 'chaos.jsonl'))


def chaos_faults_total() -> metrics.Counter:
    return metrics.counter('skytpu_chaos_faults_total',
                           'Faults injected by the chaos subsystem',
                           labelnames=('site', 'effect'))
