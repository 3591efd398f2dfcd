"""Continuous batching engine over the paged KV pool (mirrors
`skypilot_tpu/serve/batching_engine.py`, paged mode).

A fixed pool of slots is the batch dimension.  Requests join a running
batch the moment a slot frees, and one `decode.paged_engine_step` per
tick advances every active slot by a token.  submit() may be called
from any thread; one worker thread owns the device state (the page
pool, the block tables, the per-slot state) and is the only thread
that touches it.

- Paged KV: a pool of N pages [L, N, h_kv, page_size, d] with per-slot
  block tables.  Admission allocates ceil((prompt + max_new - 1) /
  page_size) pages and BACKPRESSURES on exhaustion (QueueFull -> 429 +
  Retry-After) instead of failing.  `quantize_kv` stores int8 pages
  with per-token scales; `prefix_caching` lets prompts that share full
  pages adopt them instead of prefilling them again.
- Pipelined ticks: token selection and stop bookkeeping run on the
  device inside the tick, so tick t+1's input is tick t's output.  The
  worker dispatches tick t+1 before it reads tick t's tokens
  (`.tolist()` is the only host sync of a plain tick), one tick behind.
- Chunked prefill: the prompt's first n-1 tokens are prefilled in
  chunks between ticks (at most one chunk per tick).  Chunk 0 runs the
  flash kernel on the prompt padded to a power-of-two bucket, later
  chunks the masked path at index > 0; the slot then joins at length
  n-1 with the LAST prompt token as its first tick input, which
  overwrites the first pad position, so logits match unpadded decode.
  A prefix-cache hit seeds the private cache from the pool instead of
  running chunk 0.
- Speculative ticks (`spec_tokens` = k > 0): a host n-gram drafter
  proposes k tokens per slot, one verify tick checks them through the
  paged kernel with S = k + 1, and each slot emits its longest exact
  prefix plus the bonus token; spec ticks run synchronously.
- Deadlines: a live request past its deadline is reaped (slot and pages
  freed, DeadlineExceeded -> 504); queued ones expire at pop.

The dense (non-paged) cache mode, the legacy un-pipelined loop, live
weight swaps and KV handoff come with later slices of the port.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple, Union

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.serve import cache_manager
from skypilot_tpu_torch.serve import sampler as sampler_lib
from skypilot_tpu_torch.serve import scheduler

QueueFull = scheduler.QueueFull
QueueExpired = scheduler.QueueExpired
DeadlineExceeded = scheduler.DeadlineExceeded
PagesExhausted = cache_manager.PagesExhausted

_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

logger = logging.getLogger(__name__)


class ContinuousBatchingEngine:
    """Submit() from any thread; one worker thread owns the device."""

    def __init__(self, cfg, model, *, max_len: int = 512,
                 slots: int = 4, prefill_chunk: int = 512,
                 max_queue: int = 0,
                 queue_ttl: Optional[float] = None,
                 max_top_k: int = 64, max_stop_ids: int = 16,
                 kv_pages: Optional[int] = None, page_size: int = 16,
                 quantize_kv: bool = False,
                 prefix_caching: bool = True,
                 spec_tokens: int = 0,
                 device: Union[str, torch.device] = 'cuda') -> None:
        if kv_pages is None:
            raise NotImplementedError(
                'the dense KV cache mode (kv_pages=None) comes with a '
                'later slice of the port; pass kv_pages')
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f'model on {model.device}, engine on '
                             f'{self.device}')
        if cfg.n_experts > 0:
            raise NotImplementedError(
                'MoE serving comes with a later slice of the port')
        if max_len % page_size:
            raise ValueError(
                f'max_len {max_len} must be a multiple of page_size '
                f'{page_size} (private prefill caches scatter whole '
                'pages into the pool)')
        self.spec_tokens = int(spec_tokens)
        if self.spec_tokens < 0:
            raise ValueError(f'spec_tokens must be >= 0, got {spec_tokens}')
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.max_top_k = int(max_top_k)
        self.max_stop_ids = int(max_stop_ids)
        self.quantize_kv = bool(quantize_kv)
        self._slots = [scheduler.Slot() for _ in range(slots)]
        self._queue = scheduler.AdmissionQueue(
            max_queue=max_queue, queue_ttl=queue_ttl,
            drain_estimate=self._drain_estimate)
        self._cond = self._queue.cond
        self._stop = threading.Event()
        self._sampler = sampler_lib.SlotSampler(self.max_top_k,
                                                self.max_stop_ids)
        self._kv = cache_manager.PagedKVManager(
            int(kv_pages), int(page_size), prefix_caching=prefix_caching)
        self._cache = decode.init_paged_cache(
            cfg, int(kv_pages), int(page_size), slots,
            max_len // int(page_size), quantize_kv=quantize_kv,
            device=self.device)
        self._state = decode.init_engine_state(slots, max_stop_ids,
                                               device=self.device)
        self._failed: Optional[Exception] = None

        self._metrics_lock = threading.Lock()
        self._tokens_generated = 0
        self._ticks = 0
        self._prefill_chunks = 0
        self._page_deferrals = 0
        self._deadline_reaped = 0
        self._spec_ticks = 0
        self._spec_slot_ticks = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._rate_window: Deque[Tuple[float, int]] = collections.deque()

        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public

    def submit(self, prompt_ids: List[int], max_new_tokens: int,
               stop_token=None, sampling=None,
               request_id: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> scheduler.Request:
        """stop_token: None, one id, or an iterable of ids.  sampling: a
        decode.SamplingConfig (temperature <= 0 decodes greedily; a
        seeded request is deterministic whatever else is in flight).
        deadline_ms: total time budget from submission."""
        if not prompt_ids:
            raise ValueError('empty prompt')
        if max_new_tokens < 1:
            raise ValueError(
                f'max_new_tokens must be >= 1, got {max_new_tokens}')
        if len(prompt_ids) + max_new_tokens > self.max_len:
            raise ValueError(
                f'prompt {len(prompt_ids)} + new {max_new_tokens} '
                f'exceeds max_len {self.max_len}')
        vocab = self.cfg.vocab_size
        if any(not 0 <= int(t) < vocab for t in prompt_ids):
            raise ValueError(f'prompt ids must lie in [0, {vocab})')
        temperature, top_k, seed = sampler_lib.validate_sampling(
            sampling, max_top_k=self.max_top_k)
        request = scheduler.Request(prompt_ids, max_new_tokens, stop_token,
                                    temperature=temperature, top_k=top_k,
                                    seed=seed, request_id=request_id,
                                    deadline_ms=deadline_ms)
        sampler_lib.validate_stop_ids(request.stop_ids, self.max_stop_ids)
        if self._stop.is_set() or self._failed is not None:
            raise RuntimeError('batching engine is stopped'
                               if self._failed is None else
                               f'batching engine failed: {self._failed}')
        need = self._kv.pages_needed(len(prompt_ids), max_new_tokens)
        if need > self._kv.pool.capacity:
            raise ValueError(
                f'request needs {need} KV pages > pool capacity '
                f'{self._kv.pool.capacity}')
        if len(self._queue) > 0 and not self._kv.can_admit(need):
            raise self._queue.reject(
                f'KV page pool exhausted ({need} page(s) needed, '
                f'{self._kv.pool.free_count} free); retry later')
        self._queue.submit(request)
        if self._stop.is_set() and not request.done.is_set():
            request._finish(RuntimeError('batching engine stopped'))  # pylint: disable=protected-access
        return request

    def generate(self, prompt_ids: List[int], max_new_tokens: int,
                 stop_token=None, sampling=None,
                 timeout: float = 600.0) -> List[int]:
        return self.submit(prompt_ids, max_new_tokens, stop_token,
                           sampling=sampling).result(timeout)

    def _drain_estimate(self) -> float:
        """Rough seconds until one queue position frees (Retry-After)."""
        rate = self._decode_rate()
        if rate <= 0:
            return 1.0
        return max(1.0, len(self._queue) * 32.0 /
                   (rate * max(1, len(self._slots))))

    def _decode_rate(self) -> float:
        with self._metrics_lock:
            if not self._rate_window:
                return 0.0
            span = time.monotonic() - self._rate_window[0][0]
            total = sum(n for _, n in self._rate_window)
        return total / max(span, 1e-3)

    def stats(self) -> Dict[str, Any]:
        """Scheduling, page-pool and decode counters (plain numbers)."""
        busy = sum(1 for s in self._slots if s.active)
        with self._metrics_lock:
            stats = {
                'slots': len(self._slots),
                'busy_slots': busy,
                'tokens_generated': self._tokens_generated,
                'failed': self._failed is not None,
                'ticks': self._ticks,
                'prefill_chunks': self._prefill_chunks,
                'prefill_chunk': self.prefill_chunk,
                'paged': True,
                'quantize_kv': self.quantize_kv,
                'spec_tokens': self.spec_tokens,
                'deadline_reaped': self._deadline_reaped,
                'pages_exhausted_deferrals': self._page_deferrals,
                'device': str(self.device),
            }
            if self.spec_tokens:
                stats['spec_ticks'] = self._spec_ticks
                stats['spec_proposed_tokens'] = self._spec_proposed
                stats['spec_accepted_tokens'] = self._spec_accepted
                stats['spec_accept_len_mean'] = (
                    round((self._spec_accepted + self._spec_slot_ticks) /
                          self._spec_slot_ticks, 3)
                    if self._spec_slot_ticks else None)
        stats.update(self._queue.stats())
        stats.update(self._kv.stats())
        stats['decode_tokens_per_s'] = round(self._decode_rate(), 3)
        return stats

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout=30)
        self._queue.drain(lambda: RuntimeError('batching engine stopped'))
        for slot in self._slots:
            if slot.request is not None:
                slot.request._finish(  # pylint: disable=protected-access
                    RuntimeError('batching engine stopped'))
                slot.request = None
            slot.drafter = None
        self._kv.release_all()

    # ------------------------------------------------------------ metrics

    def _record_tokens(self, n: int) -> None:
        now = time.monotonic()
        with self._metrics_lock:
            self._tokens_generated += n
            self._rate_window.append((now, n))
            while (self._rate_window and
                   now - self._rate_window[0][0] > 10.0):
                self._rate_window.popleft()

    # ------------------------------------------------------------ worker

    def _bucket(self, n: int) -> int:
        for b in _PREFILL_BUCKETS:
            if n <= b:
                return b
        return n

    def _tokens_tensor(self, ids: List[int], width: int) -> torch.Tensor:
        padded = torch.zeros((1, width), dtype=torch.int32)
        padded[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
        return padded.to(self.device)

    def _pad_row(self, row: List[int]) -> List[int]:
        return list(row) + [0] * (self.max_len // self._kv.page_size -
                                  len(row))

    def _start_admission(self, slot_id: int, request: scheduler.Request
                         ) -> Optional[scheduler.PendingPrefill]:
        """Begin admitting `request` into `slot_id`: a PendingPrefill
        when chunks remain, None when the slot went live directly.
        Raises PagesExhausted BEFORE touching any state."""
        slot = self._slots[slot_id]
        prompt = request.prompt_ids
        n = len(prompt)
        plan = self._kv.plan_admission(prompt, request.max_new_tokens)
        request.prefix_hit_pages = plan.prefix_hit_pages
        self._kv.commit(slot_id, plan)
        self._queue.record_admission(request)
        if n <= 1 or plan.n_reuse_tokens >= n - 1:
            # Nothing to prefill: a one-token prompt, or a full prefix
            # hit (the prefilled region [0, n-1) is entirely cached).
            length = 0 if n <= 1 else n - 1
            decode.paged_admit_slot(self._cache, slot_id,
                                    self._pad_row(plan.row), length)
            slot.request = request
            self._activate(slot_id, request, int(prompt[-1]))
            return None
        slot.request = request
        pending = scheduler.PendingPrefill(slot_id, request, n - 1)
        pending.plan = plan
        return pending

    def _advance_prefill(self, pending: scheduler.PendingPrefill) -> bool:
        """Run ONE chunk of a pending prefill; True when it completed
        (slot live) or was abandoned."""
        request = pending.request
        if request.cancelled or request.deadline_exceeded():
            if request.cancelled:
                request._finish()  # pylint: disable=protected-access
            else:
                with self._metrics_lock:
                    self._deadline_reaped += 1
                request._finish(DeadlineExceeded(  # pylint: disable=protected-access
                    'request deadline passed mid-prefill'))
            self._slots[pending.slot_id].request = None
            self._release_slot_pages(pending.slot_id)
            return True
        n_target = pending.n_target
        chunk = self.prefill_chunk
        plan = pending.plan
        if pending.cache is None and plan.n_reuse_tokens > 0:
            # Prefix hit: positions [0, reuse) come from the pool.
            pending.cache = decode.paged_seed_private(
                self.cfg, self._cache, plan.reuse_pages,
                priv_len=self.max_len)
            pending.consumed = plan.n_reuse_tokens
            return False
        if pending.cache is None:
            # Chunk 0: flash prefill of the bucket-padded first piece.
            take = min(n_target, chunk)
            bucket = min(self._bucket(take), self.max_len)
            _, pending.cache = decode.prefill(
                self.cfg, self.model,
                self._tokens_tensor(request.prompt_ids[:take], bucket),
                max_len=self.max_len)
            pending.cache['index'] = take
            pending.consumed = take
        else:
            # Chunk i > 0: masked continuation at index = consumed.  The
            # width (power-of-two bucket, capped at the chunk and at
            # max_len - start) keeps every write inside the cache.
            start = pending.consumed
            take = min(n_target - start, chunk)
            width = min(self._bucket(take), chunk, self.max_len - start)
            _, pending.cache = decode.prefill_chunk(
                self.cfg, self.model,
                self._tokens_tensor(
                    request.prompt_ids[start:start + take], width),
                pending.cache)
            pending.cache['index'] = start + take
            pending.consumed = start + take
        with self._metrics_lock:
            self._prefill_chunks += 1
        if pending.consumed < n_target:
            return False
        return self._finish_prefill(pending)

    def _finish_prefill(self, pending: scheduler.PendingPrefill) -> bool:
        """Scatter the fresh prompt pages into the pool, point the block
        table at the full row, publish the pages for prefix reuse, and
        join the next tick at length n-1."""
        request = pending.request
        plan = pending.plan
        ps = self._kv.page_size
        r = len(plan.reuse_pages)
        n_prompt_pages = -(-pending.n_target // ps)
        decode.insert_prefill_pages(self._cache, pending.cache,
                                    plan.row[r:n_prompt_pages],
                                    first_page=r)
        pending.cache = None
        decode.paged_admit_slot(self._cache, pending.slot_id,
                                self._pad_row(plan.row), pending.n_target)
        self._kv.register_prefix(plan)
        self._activate(pending.slot_id, request,
                       int(request.prompt_ids[-1]))
        return True

    def _activate(self, slot_id: int, request: scheduler.Request,
                  token: int) -> None:
        if self.spec_tokens:
            self._slots[slot_id].drafter = sampler_lib.NgramDrafter(
                list(request.prompt_ids) + list(request.tokens))
        self._state = self._sampler.admit(
            self._state, slot_id, token, request.max_new_tokens,
            request.stop_ids, self._sampler.key(request.seed),
            request.temperature, request.top_k)

    def _deactivate(self, slot_ids: List[int]) -> None:
        active = self._state['active'].clone()
        active[slot_ids] = False
        self._state = dict(self._state, active=active)

    def _release_slot_pages(self, slot_id: int) -> None:
        """Park the slot's table on the null page, THEN free its pages."""
        decode.paged_release_slot(self._cache, slot_id)
        self._kv.release(slot_id)

    def _finish_slot(self, slot_id: int, live: Dict[int, Any]) -> None:
        live.pop(slot_id, None)
        self._slots[slot_id].request = None
        self._slots[slot_id].drafter = None
        self._release_slot_pages(slot_id)

    def _spec_tick(self, live: Dict[int, scheduler.Request]) -> None:
        """One synchronous speculative tick (see module docstring)."""
        k = self.spec_tokens
        drafts = torch.zeros((len(self._slots), k), dtype=torch.int32)
        for slot_id in live:
            drafter = self._slots[slot_id].drafter
            if drafter is not None:
                drafts[slot_id] = torch.tensor(drafter.propose(k),
                                               dtype=torch.int32)
        self._state, self._cache, finished, toks_d, counts_d = (
            decode.paged_spec_engine_step(
                self.cfg, self.model, self._state, self._cache,
                drafts.to(self.device), max_top_k=self.max_top_k))
        toks = toks_d.tolist()
        counts = counts_d.tolist()
        fins = finished.tolist()
        pushed = accepted = slot_ticks = 0
        for slot_id, request in list(live.items()):
            if request.done.is_set():
                continue
            slot_ticks += 1
            c = int(counts[slot_id])
            emitted = toks[slot_id][:c]
            drafter = self._slots[slot_id].drafter
            if drafter is not None and emitted:
                drafter.observe(emitted)
            for token in emitted:
                request._push(token)  # pylint: disable=protected-access
            pushed += c
            accepted += max(c - 1, 0)
            if fins[slot_id]:
                self._finish_slot(slot_id, live)
                request._finish()  # pylint: disable=protected-access
        if pushed:
            self._record_tokens(pushed)
        with self._metrics_lock:
            self._ticks += 1
            self._spec_ticks += 1
            self._spec_slot_ticks += slot_ticks
            self._spec_proposed += k * len(live)
            self._spec_accepted += accepted

    def _run(self) -> None:
        try:
            if self.device.type == 'cuda':
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                self._run_pipelined()
        except Exception as e:  # pylint: disable=broad-except
            # The pool may be half-written: fail everything in flight,
            # refuse new submits, and exit the worker.
            logger.exception('batching engine tick failed')
            self._fail_everything(e)

    def _run_pipelined(self) -> None:
        # One in-flight tick: (state, finished, [(slot, request)]),
        # read one tick behind.
        inflight: Optional[Tuple[Any, Any, List[Tuple[int, Any]]]] = None
        pending_prefills: Deque[scheduler.PendingPrefill] = (
            collections.deque())
        live: Dict[int, scheduler.Request] = {}
        while not self._stop.is_set():
            self._queue.expire_stale()
            # Cancelled or deadline-expired live requests: freeze their
            # slots on device before the next dispatch, free their pages.
            now = time.monotonic()
            reaped = [(i, r.cancelled) for i, r in live.items()
                      if r.cancelled or r.deadline_exceeded(now)]
            if reaped:
                self._deactivate([i for i, _ in reaped])
                for i, was_cancel in reaped:
                    request = live[i]
                    self._finish_slot(i, live)
                    if was_cancel:
                        request._finish()  # pylint: disable=protected-access
                    else:
                        with self._metrics_lock:
                            self._deadline_reaped += 1
                        request._finish(DeadlineExceeded(  # pylint: disable=protected-access
                            'request deadline passed mid-generation'))
            # Admissions; page-pool exhaustion DEFERS the request.
            deferred = False
            for slot_id in [i for i, s in enumerate(self._slots)
                            if not s.active]:
                request = self._queue.pop()
                if request is None:
                    break
                try:
                    pending = self._start_admission(slot_id, request)
                except PagesExhausted:
                    self._queue.requeue_front(request)
                    with self._metrics_lock:
                        self._page_deferrals += 1
                    deferred = True
                    break
                if pending is not None:
                    pending_prefills.append(pending)
                else:
                    live[slot_id] = request
            # At most ONE prefill chunk between ticks.
            if pending_prefills:
                pending = pending_prefills.popleft()
                if self._advance_prefill(pending):
                    if self._slots[pending.slot_id].request is not None:
                        live[pending.slot_id] = pending.request
                else:
                    pending_prefills.append(pending)
            # Dispatch tick t+1 BEFORE reading tick t.
            dispatched = None
            if live and self.spec_tokens:
                self._spec_tick(live)   # synchronous: nothing in flight
            elif live:
                self._state, self._cache, finished = (
                    decode.paged_engine_step(
                        self.cfg, self.model, self._state, self._cache,
                        max_top_k=self.max_top_k))
                dispatched = (self._state, finished, list(live.items()))
            if inflight is not None:
                state_t, finished_t, snapshot = inflight
                toks = state_t['tokens'].tolist()   # the host sync
                fins = finished_t.tolist()
                pushed = 0
                for slot_id, request in snapshot:
                    if request.done.is_set():
                        continue
                    request._push(int(toks[slot_id]))  # pylint: disable=protected-access
                    pushed += 1
                    if fins[slot_id]:
                        self._finish_slot(slot_id, live)
                        request._finish()  # pylint: disable=protected-access
                if pushed:
                    self._record_tokens(pushed)
                with self._metrics_lock:
                    self._ticks += 1
            inflight = dispatched
            if inflight is None and not live and not pending_prefills:
                if deferred:
                    time.sleep(0.005)
                else:
                    with self._cond:
                        if not len(self._queue) and not self._stop.is_set():
                            self._cond.wait(timeout=0.05)

    def _fail_everything(self, e: Exception) -> None:
        self._failed = e
        self._stop.set()
        for slot in self._slots:
            if slot.request is not None:
                slot.request._finish(RuntimeError(  # pylint: disable=protected-access
                    f'batching engine failed: {e}'))
                slot.request = None
            slot.drafter = None
        self._queue.drain(
            lambda: RuntimeError(f'batching engine failed: {e}'))
        self._kv.release_all()
