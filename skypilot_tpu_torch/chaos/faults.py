"""The fault-plan format (a copy of `skypilot_tpu/chaos/faults.py`):
what to break, when, and how, deterministically.

A :class:`FaultPlan` is a seed plus an ordered list of :class:`Fault`s.
Each fault names a registered *site* (`SITES`, the reference's whole
vocabulary, so that every plan the reference parses arms the port the
same way), a *trigger* (nth call at the site, every k, a seeded
probability, a window after arming, and/or a ``where`` match on the
call's context) and an *effect*:

    raise    raise a typed error (``error`` picks the class)
    preempt  the reference evicts the cluster named in the context; the
             port has no cluster to evict and raises as for 'raise'
    delay    sleep ``delay_s`` then continue
    hang     sleep ``deadline_s`` then raise
    deny     return the DENY sentinel; a cooperative site reports its
             operation as refused

The port's own sites are `checkpoint.save` (data/checkpoints.py),
`serve.page_pool` (serve/cache_manager.py), `serve.kv_handoff`
(serve/batching_engine.py) and `serve.rank_exec` (serve/coordinator.py).

Plans load from JSON (inline, a path, or ``@path``), the forms of the
``SKYTPU_CHAOS_PLAN`` environment variable.  Probability draws come
from a per-fault ``random.Random(f'{seed}:{fault_index}')`` and the
per-site call counters are process-local, so the same plan and seed
over the same call sequence fire the same faults as the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Union

from skypilot_tpu_torch import exceptions

# Environment variable carrying the armed plan (inline JSON, a path to a
# .json file, or '@<path>').
PLAN_ENV_VAR = 'SKYTPU_CHAOS_PLAN'


class ChaosError(exceptions.SkyTpuError):
    """Default error raised by injected faults."""


# The reference's site vocabulary, verbatim: a plan naming any of them
# parses here as it does there.  The sites the port has a call site for
# are listed in the module docstring.
SITES: Dict[str, str] = {
    # The reference's control plane (no call site in the port).
    'provision.create': 'zone attempt before the cloud create call',
    'queued_resource.poll': 'queued-capacity poll (deny: not granted)',
    'runner.exec': 'command-runner attempt (raise: a transient error)',
    'gang.rank_exec': 'gang supervisor per-rank exec',
    'jobs.status_poll': 'managed-job status poll (preempt: an eviction)',
    'jobs.recover': 'managed-job recovery attempt',
    'serve.replica_probe': 'replica readiness probe',
    'serve.controller_tick': 'serve controller reconcile pass',
    'serve.router_push': 'router state push to a sibling router',
    'serve.role_morph': 'live role-morph of a replica',
    'batch.shard_write': 'batch-inference output/ledger write',
    'skylet.tick': 'skylet periodic event run',
    # The port's sites.
    'serve.page_pool':
        'KV page-pool allocation (serve/cache_manager.py PagePool.alloc):'
        ' deny reports exhaustion (PagesExhausted: admission '
        'backpressure, never an engine failure); delay slows admissions',
    'serve.rank_exec':
        'slice-replica rank command execution (serve/coordinator.py '
        '_execute): a raise is that rank\'s host dying mid-command, and '
        'the replica fails as a unit',
    'serve.kv_handoff':
        'KV page handoff import (serve/batching_engine.py import_pages): '
        'deny refuses the pages (HandoffRejected: the router falls back '
        'to a local prefill); delay adds handoff latency',
    'checkpoint.save':
        'checkpoint write attempt (data/checkpoints.py '
        'AsyncCheckpointManager): a raise is a write flake that the '
        'retry loop retries',
}

EFFECTS = ('raise', 'preempt', 'delay', 'hang', 'deny')

# Name -> exception class for the `raise` effect: the reference's
# errors that the port's sites can meet.  Its control-plane errors
# (ProvisionError, CommandError, ...) are refused when a fault naming
# one fires, as the reference refuses a name it does not know.
ERROR_TYPES: Dict[str, Any] = {
    'ChaosError': ChaosError, 'TimeoutError': TimeoutError,
    'OSError': OSError, 'RuntimeError': RuntimeError}


@dataclasses.dataclass
class Fault:
    """One fault: site + trigger + effect."""
    site: str
    effect: str = 'raise'
    # Effect parameters.
    error: str = 'ChaosError'
    message: Optional[str] = None
    delay_s: float = 0.0
    deadline_s: float = 0.0
    # preempt only: the host ranks to evict (a partial preemption in the
    # reference); None/empty: the whole cluster.
    ranks: Optional[Sequence[int]] = None
    # Trigger: at most one of nth/every/probability; all other given
    # conditions AND together.  Call numbers are 1-based per site.
    nth: Optional[Union[int, Sequence[int]]] = None
    every: Optional[int] = None
    probability: Optional[float] = None
    max_times: Optional[int] = None
    after_s: float = 0.0
    until_s: Optional[float] = None
    where: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(
                f'Unknown chaos site {self.site!r}; registered sites: '
                f'{sorted(SITES)}')
        if self.effect not in EFFECTS:
            raise ValueError(
                f'Unknown chaos effect {self.effect!r}; one of {EFFECTS}')
        selectors = [s for s in (self.nth, self.every, self.probability)
                     if s is not None]
        if len(selectors) > 1:
            raise ValueError(
                'A fault takes at most one of nth/every/probability')
        if self.probability is not None and not 0.0 <= self.probability <= 1.0:
            raise ValueError('probability must be in [0, 1]')
        if isinstance(self.nth, int):
            self.nth = [self.nth]
        elif self.nth is not None:
            self.nth = [int(n) for n in self.nth]
        if self.ranks is not None:
            self.ranks = [int(r) for r in self.ranks]
            if self.effect != 'preempt':
                raise ValueError(
                    "'ranks' (partial preemption) only applies to the "
                    "'preempt' effect")

    def matches_ctx(self, ctx: Dict[str, Any]) -> bool:
        """`where` is satisfied iff every key is present in ctx with an
        equal value (string-compared, so JSON '1' matches int rank 1)."""
        for key, want in self.where.items():
            if key not in ctx or str(ctx[key]) != str(want):
                return False
        return True

    def make_error(self) -> Exception:
        message = self.message or (
            f'chaos: injected {self.error} at {self.site}')
        cls = ERROR_TYPES.get(self.error)
        if cls is None:
            raise ValueError(f'Unknown chaos error type {self.error!r}; '
                             f'one of {sorted(ERROR_TYPES)}')
        return cls(message)

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        # Drop defaults for compact plans.
        for key, default in (('error', 'ChaosError'), ('message', None),
                             ('delay_s', 0.0), ('deadline_s', 0.0),
                             ('ranks', None),
                             ('nth', None), ('every', None),
                             ('probability', None), ('max_times', None),
                             ('after_s', 0.0), ('until_s', None),
                             ('where', {})):
            if out.get(key) == default:
                out.pop(key, None)
        return out


@dataclasses.dataclass
class FaultPlan:
    """A seed + ordered faults.  First matching fault at a site wins."""
    seed: int = 0
    faults: List[Fault] = dataclasses.field(default_factory=list)
    name: str = ''

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> 'FaultPlan':
        if not isinstance(data, dict):
            raise ValueError(f'Fault plan must be a JSON object, got '
                             f'{type(data).__name__}')
        unknown = set(data) - {'seed', 'faults', 'name'}
        if unknown:
            raise ValueError(f'Unknown fault-plan keys: {sorted(unknown)}')
        faults = [f if isinstance(f, Fault) else Fault(**f)
                  for f in data.get('faults', [])]
        return cls(seed=int(data.get('seed', 0)), faults=faults,
                   name=str(data.get('name', '')))

    @classmethod
    def from_json(cls, text: str) -> 'FaultPlan':
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_env_value(cls, value: str) -> 'FaultPlan':
        """Parse the SKYTPU_CHAOS_PLAN forms: inline JSON, '@<path>', or
        a bare path ending in .json."""
        value = value.strip()
        if value.startswith('@'):
            path = os.path.expanduser(value[1:])
            with open(path, encoding='utf-8') as f:
                return cls.from_json(f.read())
        if value.endswith('.json') and not value.startswith('{'):
            with open(os.path.expanduser(value), encoding='utf-8') as f:
                return cls.from_json(f.read())
        return cls.from_json(value)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {'seed': self.seed,
                               'faults': [f.to_dict() for f in self.faults]}
        if self.name:
            out['name'] = self.name
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def sites(self) -> List[str]:
        return sorted({f.site for f in self.faults})
