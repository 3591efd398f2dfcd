"""Request lifecycle + bounded admission queue for the batching engine
(mirrors `skypilot_tpu/serve/scheduler.py`).

- `Request`: the handle submit() returns (token stream, result(),
  stream(), cancel(); the first finish wins), with its `RequestSpan`
  (observability/tracing.py); a finished span lands in the engine's
  span store.  Its QoS class clamps `max_new_tokens` to the class
  budget and lends the class deadline; watchers (`add_watcher`) get
  every token, the tokens already pushed first.
- `AdmissionQueue`: bounded queue with TTL.  `max_queue` rejects new
  submits (`QueueFull` -> HTTP 429 + Retry-After) and `queue_ttl`
  expires stale waiters (`QueueExpired` -> 503).  FIFO within a QoS
  class; across classes, smooth weighted round-robin by class weight.
- `RoleBudget`: per-tick prefill and decode token budgets (the replica's
  role as a fraction): the engine clamps each prefill chunk to the
  prefill budget and stops admitting decode slots at the decode budget.
- `Slot` / `PendingPrefill`: per-slot host bookkeeping.

Admissions (also by QoS class), rejections (by reason), queue depth and
wait, TTFT, inter-token gaps and the budget in force go into the
reference's process-global instruments (`GET /metrics`); the per-engine
view stays in `stats()`.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve import qos as qos_lib
from skypilot_tpu_torch.serve import roles as roles_lib

# Queue-wait histogram bucket upper bounds (seconds); the last bucket
# is open-ended.
WAIT_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

_M_ADMITTED = metrics_lib.counter(
    'skytpu_engine_admitted_total',
    'Requests admitted into a KV slot.')
_M_REJECTED = metrics_lib.counter(
    'skytpu_engine_rejected_total',
    'Requests rejected at admission, by reason.', ('reason',))
_M_QUEUE_DEPTH = metrics_lib.gauge(
    'skytpu_engine_queue_depth', 'Requests waiting for a slot.')
_M_QUEUE_WAIT = metrics_lib.histogram(
    'skytpu_engine_queue_wait_seconds',
    'Seconds a request waited queued before admission.',
    buckets=WAIT_BUCKETS)
_M_TTFT = metrics_lib.histogram(
    'skytpu_engine_ttft_seconds',
    'Submit-to-first-token latency per request.')
_M_ITL = metrics_lib.histogram(
    'skytpu_engine_itl_seconds',
    'Inter-token gaps during decode.',
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0))
_M_QOS_ADMITTED = metrics_lib.counter(
    'skytpu_engine_qos_admitted_total',
    'Requests admitted into a KV slot, by QoS class.', ('qos_class',))
_M_PREFILL_BUDGET = metrics_lib.gauge(
    'skytpu_engine_prefill_budget_tokens',
    'Per-tick prefill token budget in force (fractional role; set on '
    'every budget swap).')
_M_DECODE_BUDGET = metrics_lib.gauge(
    'skytpu_engine_decode_budget_tokens',
    'Per-tick decode token budget in force (caps concurrent decode '
    'slots; set on every budget swap).')
_M_BUDGET_SWAPS = metrics_lib.counter(
    'skytpu_engine_budget_swaps_total',
    'Role-budget swaps applied (controller rebalance pushes + live '
    'role morphs).')


class QueueFull(RuntimeError):
    """submit() rejected: the queue is at max_queue, or the page pool
    cannot cover the request while a backlog waits (HTTP 429)."""

    def __init__(self, message: str, retry_after: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after = max(1.0, retry_after)


class QueueExpired(RuntimeError):
    """The request sat queued past queue_ttl (HTTP 503)."""

    def __init__(self, message: str, retry_after: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after = max(1.0, retry_after)


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it finished (HTTP 504)."""


class Request:

    def __init__(self, prompt_ids: List[int], max_new_tokens: int,
                 stop_token, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, request_id: Optional[str] = None,
                 route_meta: Optional[Dict[str, Any]] = None,
                 deadline_ms: Optional[float] = None,
                 qos_class: Optional[str] = None) -> None:
        self.prompt_ids = list(prompt_ids)
        # QoS class (X-SkyTPU-QoS-Class): its token budget clamps
        # max_new_tokens, and its deadline default applies when the
        # request carries no deadline of its own.
        self.qos_class = qos_lib.normalize(qos_class)
        qos_spec = qos_lib.engine_config().get(self.qos_class)
        if qos_spec is not None:
            if qos_spec.max_new_tokens is not None:
                max_new_tokens = min(int(max_new_tokens),
                                     qos_spec.max_new_tokens)
            if deadline_ms is None and qos_spec.deadline_ms is not None:
                deadline_ms = qos_spec.deadline_ms
        self.max_new_tokens = max_new_tokens
        # Per-request phase trace; the id arrives via
        # X-SkyTPU-Request-Id or is generated here.
        self.span = tracing.RequestSpan(request_id)
        self.request_id = self.span.request_id
        if route_meta:
            # Routing facts the LB forwarded, stamped into the span.
            self.span.routed_role = route_meta.get('routed_role')
            self.span.affinity_hit = route_meta.get('affinity_hit')
            self.span.handoff_ms = route_meta.get('handoff_ms')
            self.span.attempt = route_meta.get('attempt')
        if stop_token is None:
            self.stop_ids = frozenset()
        elif isinstance(stop_token, int):
            self.stop_ids = frozenset({stop_token})
        else:
            self.stop_ids = frozenset(int(t) for t in stop_token)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.submit_time = time.monotonic()
        self.deadline: Optional[float] = (
            self.submit_time + float(deadline_ms) / 1e3
            if deadline_ms is not None else None)
        self.done = threading.Event()
        self.tokens: List[int] = []
        self.error: Optional[Exception] = None
        self.cancelled = False
        self._live: 'queue.Queue[Optional[int]]' = queue.Queue()
        self._state_lock = threading.Lock()
        # Event-loop bridges (serve/async_server.py): called with each
        # token and a final None, from the pushing thread (the engine
        # worker).  They run outside the state lock; the notify lock
        # keeps every watcher's tokens in order and each exactly once.
        self._watchers: List[Callable[[Optional[int]], Any]] = []
        self._notify_lock = threading.Lock()
        # Set by the engine at submit(): finished spans land here.
        self._span_store: Optional[tracing.SpanStore] = None

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-token seconds (None before the first token)."""
        return self.span.ttft_s

    def add_watcher(self, fn: Callable[[Optional[int]], Any]) -> None:
        """Subscribe fn(token | None) to this request's token stream;
        the tokens already pushed are replayed first (the first token
        can land before the caller holds the handle).  A watcher must be
        cheap and must not block (`loop.call_soon_threadsafe` is); one
        that raises is dropped."""
        with self._notify_lock:
            with self._state_lock:
                replay = list(self.tokens)
                done = self.done.is_set()
                if not done:
                    self._watchers.append(fn)
            try:
                for token in replay:
                    fn(token)
                if done:
                    fn(None)
            except Exception:  # pylint: disable=broad-except
                self._drop_watcher(fn)

    def _drop_watcher(self, fn) -> None:
        with self._state_lock:
            if fn in self._watchers:
                self._watchers.remove(fn)

    def _notify(self, token: Optional[int]) -> None:
        """Call every watcher with `token` (notify lock held, state lock
        not).  A raising watcher (a closed event loop at shutdown) must
        not fail the engine worker: it is dropped."""
        with self._state_lock:
            watchers = list(self._watchers)
            if token is None:
                self._watchers.clear()
        for fn in watchers:
            try:
                fn(token)
            except Exception:  # pylint: disable=broad-except
                self._drop_watcher(fn)

    def _push(self, token: int) -> None:
        with self._notify_lock:
            with self._state_lock:
                if self.done.is_set():
                    return
                gap = self.span.mark_token()
                if gap is None:
                    if self.span.ttft_s is not None:
                        _M_TTFT.observe(self.span.ttft_s)
                else:
                    _M_ITL.observe(gap)
                self.tokens.append(token)
                self._live.put(token)
            self._notify(token)

    def _finish(self, error: Optional[Exception] = None) -> None:
        with self._notify_lock:
            with self._state_lock:
                if self.done.is_set():
                    return
                self.error = error
                if error is not None:
                    status = type(error).__name__
                elif self.cancelled:
                    status = 'cancelled'
                else:
                    status = 'ok'
                self.span.finish(status)
                if self._span_store is not None:
                    self._span_store.add(self.span)
                # Done only once the span is stored, so a caller that
                # result() wakes finds it (the reference sets done
                # first).
                self.done.set()
                self._live.put(None)
            self._notify(None)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError('generation timed out')
        if self.error is not None:
            raise self.error
        return self.tokens

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as the engine produces them."""
        while True:
            token = self._live.get(timeout=timeout)
            if token is None:
                if self.error is not None:
                    raise self.error
                return
            yield token

    def cancel(self) -> None:
        """Stop generating (the engine frees the slot on its next tick)."""
        self.cancelled = True

    def deadline_exceeded(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None and
                (time.monotonic() if now is None else now) > self.deadline)


class Slot:

    def __init__(self) -> None:
        self.request: Optional[Request] = None
        self.drafter = None          # NgramDrafter when spec decoding
        self.next_token = 0          # the legacy loop's next input

    @property
    def active(self) -> bool:
        return self.request is not None


class PendingPrefill:
    """A prompt mid-chunked-prefill: the slot is reserved but joins
    decode ticks only once every chunk has run."""

    def __init__(self, slot_id: int, request: Request,
                 n_target: int) -> None:
        self.slot_id = slot_id
        self.request = request
        self.n_target = n_target     # tokens to prefill (n - 1)
        self.consumed = 0
        self.cache: Optional[Dict[str, Any]] = None  # private [*, 1, ..]
        self.plan: Optional[Any] = None   # cache_manager.AdmissionPlan
        self.weight_epoch = 0             # the engine's epoch at admission


@dataclasses.dataclass
class RoleBudget:
    """Per-tick token budgets that make a replica's role fractional.

    ``prefill_tokens`` caps the prompt tokens one prefill chunk may take;
    ``decode_tokens`` caps the decode tokens a tick may spend, which at
    one token per busy slot is a cap on concurrent decode slots,
    enforced at admission (running decodes always finish).  Both floor
    at 1: a starved phase still makes a token of progress per tick.
    ``split`` is the prefill share the budget came from; ``version``
    orders pushes, so a stale one never overwrites a newer one.
    """
    prefill_tokens: int
    decode_tokens: int
    role: str = roles_lib.DEFAULT_ROLE
    split: float = 0.5
    version: int = 0

    def __post_init__(self) -> None:
        self.prefill_tokens = max(1, int(self.prefill_tokens))
        self.decode_tokens = max(1, int(self.decode_tokens))
        self.split = min(1.0, max(0.0, float(self.split)))
        self.version = int(self.version)
        if self.role not in roles_lib.ROLES:
            raise ValueError(f'Unknown role {self.role!r}; one of '
                             f'{roles_lib.ROLES}')

    @classmethod
    def from_split(cls, split: float, *, slots: int,
                   prefill_chunk: int,
                   role: str = roles_lib.DEFAULT_ROLE,
                   version: int = 0) -> 'RoleBudget':
        """Budget from a prefill share in [0, 1]: at 0.5 both phases run
        unclamped; toward either end the other phase starves linearly
        down to its 1-token floor."""
        split = min(1.0, max(0.0, float(split)))
        return cls(
            prefill_tokens=round(prefill_chunk * min(1.0, 2 * split)),
            decode_tokens=round(slots * min(1.0, 2 * (1 - split))),
            role=role, split=split, version=version)

    @classmethod
    def for_role(cls, role: str, *, slots: int, prefill_chunk: int,
                 version: int = 0) -> 'RoleBudget':
        """The launch-time profile of a static role: prefill replicas
        spend their ticks prefilling (decode floor), decode replicas the
        reverse, mixed replicas are unclamped."""
        return cls.from_split(roles_lib.DEFAULT_SPLITS[role],
                              slots=slots, prefill_chunk=prefill_chunk,
                              role=role, version=version)

    def as_dict(self) -> Dict[str, Any]:
        return {'role': self.role, 'split': self.split,
                'prefill_tokens': self.prefill_tokens,
                'decode_tokens': self.decode_tokens,
                'version': self.version}


class AdmissionQueue:
    """Bounded, TTL'd queue between submit() threads and the worker."""

    def __init__(self, max_queue: int = 0,
                 queue_ttl: Optional[float] = None,
                 drain_estimate: Callable[[], float] = lambda: 1.0
                 ) -> None:
        self.max_queue = int(max_queue)      # 0 = unbounded
        self.queue_ttl = queue_ttl           # None = no expiry
        self._drain_estimate = drain_estimate
        self._queue: Deque[Request] = collections.deque()
        # Per-tick role budget (None = unclamped), swapped under the
        # condition lock by set_role_budget.
        self.role_budget: Optional[RoleBudget] = None
        self.budget_swaps = 0
        # Smooth weighted round-robin credits per QoS class.
        self._wrr_credit: Dict[str, int] = {}
        self.cond = threading.Condition()
        self._metrics_lock = threading.Lock()
        self.queue_full_rejections = 0
        self.queue_ttl_expiries = 0
        self.admitted = 0
        self.wait_hist = [0] * (len(WAIT_BUCKETS) + 1)
        _M_QUEUE_DEPTH.set(0)

    def __len__(self) -> int:
        with self.cond:
            return len(self._queue)

    def submit(self, request: Request) -> None:
        """Append (FIFO) or reject with QueueFull at the bound."""
        with self.cond:
            if self.max_queue and len(self._queue) >= self.max_queue:
                with self._metrics_lock:
                    self.queue_full_rejections += 1
                _M_REJECTED.labels(reason='queue_full').inc()
                raise QueueFull(
                    f'admission queue full ({self.max_queue} waiting); '
                    'retry later', retry_after=self._drain_estimate())
            self._queue.append(request)
            _M_QUEUE_DEPTH.set(len(self._queue))
            self.cond.notify()

    def set_role_budget(self, budget: Optional[RoleBudget]) -> bool:
        """Install a per-tick budget (None = unclamped).  A push older
        than the budget in force (lower version) is dropped; returns
        whether the swap was applied."""
        with self.cond:
            current = self.role_budget
            if (budget is not None and current is not None and
                    budget.version < current.version):
                return False
            self.role_budget = budget
            self.budget_swaps += 1
            self.cond.notify_all()
        _M_BUDGET_SWAPS.inc()
        if budget is not None:
            _M_PREFILL_BUDGET.set(budget.prefill_tokens)
            _M_DECODE_BUDGET.set(budget.decode_tokens)
        return True

    def admission_allowed(self, busy_slots: int) -> bool:
        """May this tick admit one more decode slot?  Admission stops
        once the busy slots reach the decode budget."""
        budget = self.role_budget
        return budget is None or busy_slots < budget.decode_tokens

    def prefill_tokens_per_tick(self, default: int) -> int:
        """Prompt tokens one prefill chunk may take (`default`, the
        engine's chunk, when unclamped)."""
        budget = self.role_budget
        if budget is None:
            return default
        return min(default, budget.prefill_tokens)

    def reject(self, reason: str, message: str) -> QueueFull:
        """Count a non-queue-bound rejection (page-pool exhaustion) and
        build the QueueFull to raise."""
        with self._metrics_lock:
            self.queue_full_rejections += 1
        _M_REJECTED.labels(reason=reason).inc()
        return QueueFull(message, retry_after=self._drain_estimate())

    def requeue_front(self, request: Request) -> None:
        """Put a popped-but-not-admitted request back at the head."""
        with self.cond:
            self._queue.appendleft(request)
            _M_QUEUE_DEPTH.set(len(self._queue))

    def _pop_index_locked(self) -> int:
        """Index of the next request to pop: FIFO within a class; across
        classes, smooth weighted round-robin by class weight (call with
        self.cond held)."""
        first_of: Dict[str, int] = {}
        for idx, request in enumerate(self._queue):
            if request.qos_class not in first_of:
                first_of[request.qos_class] = idx
        if len(first_of) <= 1:
            return 0
        specs = qos_lib.engine_config()
        total = 0
        for cls in first_of:
            weight = specs[cls].weight if cls in specs else 1
            self._wrr_credit[cls] = self._wrr_credit.get(cls, 0) + weight
            total += weight
        chosen = max(first_of,
                     key=lambda c: (self._wrr_credit.get(c, 0), c))
        self._wrr_credit[chosen] -= total
        return first_of[chosen]

    def pop(self) -> Optional[Request]:
        """Pop the next live request, finishing cancelled, deadlined and
        expired ones on the way."""
        while True:
            with self.cond:
                if not self._queue:
                    return None
                index = self._pop_index_locked()
                request = self._queue[index]
                del self._queue[index]
                _M_QUEUE_DEPTH.set(len(self._queue))
            if request.cancelled:
                request._finish()  # pylint: disable=protected-access
                continue
            if request.deadline_exceeded():
                _M_REJECTED.labels(reason='deadline_exceeded').inc()
                request._finish(DeadlineExceeded(  # pylint: disable=protected-access
                    'request deadline passed while queued'))
                continue
            if (self.queue_ttl is not None and
                    time.monotonic() - request.submit_time > self.queue_ttl):
                self._record_expiry(1)
                request._finish(QueueExpired(  # pylint: disable=protected-access
                    f'request expired after {self.queue_ttl}s queued',
                    retry_after=self._drain_estimate()))
                continue
            return request

    def record_admission(self, request: Request) -> None:
        request.span.mark_admitted()
        wait = time.monotonic() - request.submit_time
        _M_ADMITTED.inc()
        _M_QOS_ADMITTED.labels(qos_class=request.qos_class).inc()
        _M_QUEUE_WAIT.observe(wait)
        with self._metrics_lock:
            self.admitted += 1
            for i, bound in enumerate(WAIT_BUCKETS):
                if wait < bound:
                    self.wait_hist[i] += 1
                    return
            self.wait_hist[-1] += 1

    def _record_expiry(self, n: int) -> None:
        with self._metrics_lock:
            self.queue_ttl_expiries += n
        _M_REJECTED.labels(reason='queue_expired').inc(n)

    def expire_stale(self) -> None:
        """Fail queued requests past queue_ttl or their own deadline."""
        now = time.monotonic()
        expired, deadlined = [], []
        with self.cond:
            if not self._queue:
                return
            keep: Deque[Request] = collections.deque()
            for request in self._queue:
                if request.deadline_exceeded(now):
                    deadlined.append(request)
                elif (self.queue_ttl is not None and
                      now - request.submit_time > self.queue_ttl):
                    expired.append(request)
                else:
                    keep.append(request)
            self._queue = keep
            _M_QUEUE_DEPTH.set(len(keep))
        if expired:
            self._record_expiry(len(expired))
        for request in expired:
            request._finish(QueueExpired(  # pylint: disable=protected-access
                f'request expired after {self.queue_ttl}s queued',
                retry_after=self._drain_estimate()))
        if deadlined:
            _M_REJECTED.labels(reason='deadline_exceeded').inc(
                len(deadlined))
        for request in deadlined:
            request._finish(DeadlineExceeded(  # pylint: disable=protected-access
                'request deadline passed while queued'))

    def drain(self, error_factory: Callable[[], Exception]) -> None:
        """Fail everything still queued (shutdown/engine failure)."""
        while True:
            with self.cond:
                if not self._queue:
                    _M_QUEUE_DEPTH.set(0)
                    return
                request = self._queue.popleft()
            request._finish(error_factory())  # pylint: disable=protected-access

    def stats(self) -> Dict[str, Any]:
        hist = {}
        with self._metrics_lock:
            for i, bound in enumerate(WAIT_BUCKETS):
                hist[f'<{bound}s'] = self.wait_hist[i]
            hist[f'>={WAIT_BUCKETS[-1]}s'] = self.wait_hist[-1]
            return {
                'queued_requests': len(self._queue),
                'admitted_requests': self.admitted,
                'queue_full_rejections': self.queue_full_rejections,
                'queue_ttl_expiries': self.queue_ttl_expiries,
                'queue_wait_hist': hist,
                'max_queue': self.max_queue,
                'role_budget': (self.role_budget.as_dict()
                                if self.role_budget is not None
                                else None),
                'budget_swaps': self.budget_swaps,
            }
