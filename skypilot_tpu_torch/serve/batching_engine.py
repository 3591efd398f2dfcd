"""Continuous batching engine (mirrors
`skypilot_tpu/serve/batching_engine.py`).

A fixed pool of slots is the batch dimension.  Requests join a running
batch the moment a slot frees, and one engine step per tick advances
every active slot by a token.  submit() may be called from any thread;
one worker thread owns the device state (the KV cache, the per-slot
state) and is the only thread that touches it.

KV cache modes:
- Dense (the default, `kv_pages=None`): one slot cache
  [L, slots, h_kv, max_len, d]; each tick is `decode.engine_step`
  (masked grouped attention, every slot at its own depth).
- Paged (`kv_pages=N`): a pool of N pages [L, N, h_kv, page_size, d]
  with per-slot block tables; each tick is `decode.paged_engine_step`
  (the paged kernel).  Admission allocates ceil((prompt + max_new - 1)
  / page_size) pages and BACKPRESSURES on exhaustion (QueueFull -> 429
  + Retry-After) instead of failing.  `quantize_kv` stores int8 pages
  with per-token scales; `prefix_caching` lets prompts that share full
  pages adopt them instead of prefilling them again.

Loops:
- Pipelined (the default): token selection and stop bookkeeping run on
  the device inside the tick, so tick t+1's input is tick t's output.
  The worker dispatches tick t+1 before it reads tick t's tokens
  (`.tolist()` is the only host sync of a plain tick), one tick behind.
  The prompt's first n-1 tokens are prefilled in chunks between ticks
  (at most one chunk per tick): chunk 0 runs the flash kernel on the
  prompt padded to a power-of-two bucket, later chunks the masked path
  at index > 0; the slot then joins at length n-1 with the LAST prompt
  token as its first tick input, which overwrites the first pad
  position, so logits match unpadded decode.  A prefix-cache hit seeds
  the private cache from the pool instead of running chunk 0.
- MoE models (cfg.n_experts > 0): the capacity dispatch couples every
  prompt token, so a pad, the n-1 / last-token split or a chunk
  boundary would change which tokens drop.  Admission prefills the
  WHOLE prompt unpadded in one piece (`_admit_moe`), takes the first
  token from its logits with the key a first tick would use, and the
  slot joins at length n; prefixes are never reused (pages still pool)
  and KV handoff is refused.  A speculative verify tick dispatches all
  B * (k + 1) rows, inactive slots' too, as the reference does.
- Legacy (`pipelined=False`, dense cache only): the whole prompt
  prefills inline at admission, every tick is `decode.batched_step`
  with one host sync per token, greedy only.  It is the un-pipelined
  A/B baseline.
- Speculative ticks (`spec_tokens` = k > 0, paged only): a host n-gram
  drafter proposes k tokens per slot, one verify tick checks them
  through the paged kernel with S = k + 1, and each slot emits its
  longest exact prefix plus the bonus token; spec ticks run
  synchronously.
- Deadlines: a live request past its deadline is reaped (slot and pages
  freed, DeadlineExceeded -> 504); queued ones expire at pop.
- Role budgets (`set_role_budget`, scheduler.RoleBudget): the pipelined
  loop clamps each prefill chunk of an admission to the budget's
  prefill tokens (chunk 0 and the continuations alike) and admits no
  slot once the occupied slots reach its decode tokens.  Budgets change
  when tokens come, never which.  The legacy loop and the exports are
  not clamped, as in the reference.
- Cancellation (a client that hung up): the worker reaps the slot and
  frees its pages between ticks; a page it reassigns is written only by
  later launches on the engine's stream, after the tick in flight.

Host ops: KV imports, prefix exports and weight swaps touch state only
the worker owns, so callers queue a closure (`_on_worker`) that the
worker runs between ticks, in both loops; stop or failure errors out
the ones still queued.
- KV handoff: `export_prefill` prefills a prompt into a private cache
  (never the slot pool) and returns its full pages in the
  `serve/handoff.py` wire format; `import_pages` adopts such pages into
  the pool and publishes them in the prefix cache, so the request that
  follows lands as a prefix hit; `export_prefix_pages` ships the
  hottest cached pages (no prefill).
- `swap_params` replaces the served weights between ticks without
  dropping the KV or an in-flight request, and bumps `weight_epoch`.

`stream`: on CUDA, the engine's own stream; its ticks, host ops and
exports all run there, so two engines of one process run their ticks
at once.  None on the CPU.

Slices: `mesh=` (parallel/mesh.py) places the engine on the mesh's
first device; every tick goes through `_dispatch_step` /
`_dispatch_spec_step`, which the slice engine (serve/slice_replica.py)
overrides to broadcast the tick to its ranks first.

Tensor ranks: a `TensorParallel` model (models/tensor_parallel.py)
gives the engine one pool (paged or dense) per tensor rank, on the
rank's device, through the same decode functions; the block tables,
the lengths, the page allocator, the prefix cache and the per-slot
state stay single, on rank 0's device (the engine's), so one page id
names the same page in every rank's pool and a tick's rollback,
release or prefix adoption touches every pool alike.  The tick keeps
its one set of host reads.  Exports join the ranks' kv heads into the
tensor-1 wire layout and imports split them (`decode.read_pages`,
`decode.write_pages`).

Observability (observability/, as the reference wires it): the
reference's engine instruments in the process-global registry
(`GET /metrics`); a `RequestSpan` per request (`stats()['recent_spans']`,
`span(id)`, `GET /spans`); a `TickProfiler` whose host-clock laps split
every tick of all three loops into the reference's phases, and a
`RecompileSentinel` over the step entries (`profile()`, `GET /profile`).
None of it touches the device: the tick's one host sync stays where it
is, and the lap after it carries the wait for the device.

The flight recorder (observability/events.py, as the reference wires
it): each pipelined worker's run is a `tick_profile_start` / `_end`
pair in the serving journal (`profiling.serve_journal`); page
alloc/free events go there only while someone watches (the
`serve.page_pool` chaos site armed, or SKYTPU_SERVE_PAGE_EVENTS set),
so a tick does no I/O otherwise; `import_pages` is the
`serve.kv_handoff` chaos site (a deny raises `HandoffRejected`).
"""
from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from skypilot_tpu_torch.chaos import injector as chaos_injector
from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.observability import logs as logs_lib
from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import profiling
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve import cache_manager
from skypilot_tpu_torch.serve import handoff as handoff_lib
from skypilot_tpu_torch.serve import sampler as sampler_lib
from skypilot_tpu_torch.serve import scheduler

QueueFull = scheduler.QueueFull
QueueExpired = scheduler.QueueExpired
DeadlineExceeded = scheduler.DeadlineExceeded
RoleBudget = scheduler.RoleBudget
PagesExhausted = cache_manager.PagesExhausted
HandoffError = handoff_lib.HandoffError
HandoffRejected = handoff_lib.HandoffRejected

_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def prefill_bucket(n: int) -> int:
    """The smallest prefill bucket that holds n tokens (n past the
    largest)."""
    for b in _PREFILL_BUCKETS:
        if n <= b:
            return b
    return n


def tokens_tensor(ids: List[int], width: int, device) -> torch.Tensor:
    """ids as a [1, width] int32 tensor on `device`, zero-padded."""
    padded = torch.zeros((1, width), dtype=torch.int32)
    padded[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return padded.to(device)


def prefill_piece(cfg, model, prompt_ids: List[int],
                  cache: Optional[Dict[str, Any]], consumed: int,
                  n_target: int, chunk: int, *, max_len: int, device,
                  prefill, prefill_chunk) -> Tuple[Dict[str, Any], int]:
    """Prefill the next piece, at most `chunk` tokens of [consumed,
    n_target), into a private cache; returns (cache, new consumed).
    The engine's chunk loop, which a slice's followers replay:
    `prefill` and `prefill_chunk` are decode's functions or the
    engine's wrapped ones."""
    if cache is None:
        # Chunk 0: flash prefill of the bucket-padded first piece.
        take = min(n_target, chunk)
        bucket = min(prefill_bucket(take), max_len)
        _, cache = prefill(cfg, model,
                           tokens_tensor(prompt_ids[:take], bucket, device),
                           max_len=max_len)
    else:
        # Chunk i > 0: masked continuation at index = consumed.  The
        # width (power-of-two bucket, capped at the chunk and at
        # max_len - consumed) keeps every write inside the cache.
        take = min(n_target - consumed, chunk)
        width = min(prefill_bucket(take), chunk, max_len - consumed)
        _, cache = prefill_chunk(
            cfg, model,
            tokens_tensor(prompt_ids[consumed:consumed + take], width,
                          device), cache)
    cache['index'] = consumed + take
    return cache, consumed + take

logger = logging.getLogger(__name__)

# Process-global registry instruments (observability/metrics.py), the
# reference's names and labels.  Counters are process-cumulative; the
# per-ENGINE view lives in stats().  Gauges describe the most recently
# constructed engine.  Queue/admission instruments live in
# serve/scheduler.py, page-pool ones in serve/cache_manager.py.
_M_TICKS = metrics_lib.counter(
    'skytpu_engine_ticks_total', 'Decode engine ticks dispatched.')
_M_TOKENS = metrics_lib.counter(
    'skytpu_engine_decode_tokens_total',
    'Tokens generated across all requests.')
_M_PREFILL_CHUNKS = metrics_lib.counter(
    'skytpu_engine_prefill_chunks_total',
    'Prompt prefill chunks executed.')
_M_BUSY_SLOTS = metrics_lib.gauge(
    'skytpu_engine_busy_slots', 'KV slots currently decoding.')
_M_SLOTS = metrics_lib.gauge(
    'skytpu_engine_slots', 'Total KV slots in the pool.')
_M_DECODE_RATE = metrics_lib.gauge(
    'skytpu_engine_decode_tokens_per_s',
    'Decode tokens/s over the trailing 10s window.')
_M_HANDOFF_EXPORTS = metrics_lib.counter(
    'skytpu_engine_handoff_exports_total',
    'KV page exports served (the prefill side of a handoff).')
_M_HANDOFF_IMPORTS = metrics_lib.counter(
    'skytpu_engine_handoff_imports_total',
    'KV page imports (the decode side of a handoff), by result.',
    ('result',))
_M_DEADLINE_REAPED = metrics_lib.counter(
    'skytpu_engine_deadline_reaped_total',
    'Decoding requests cancelled mid-generation because their '
    'X-SkyTPU-Deadline-Ms passed (slot and KV pages freed).')
_M_SPEC_PROPOSED = metrics_lib.counter(
    'skytpu_engine_spec_proposed_tokens_total',
    'Draft tokens proposed to speculative verify ticks (k per live '
    'slot per tick).')
_M_SPEC_ACCEPTED = metrics_lib.counter(
    'skytpu_engine_spec_accepted_tokens_total',
    'Draft tokens accepted by speculative verify ticks (the emitted '
    'base token per tick is not counted).')
_M_SPEC_ACCEPT_LEN = metrics_lib.histogram(
    'skytpu_engine_spec_accept_len_tokens',
    'Tokens emitted per slot per speculative verify tick (1 = every '
    'draft rejected; k+1 = all accepted plus the bonus token).',
    buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
# The reference's name, kept for the fleet: 1 when the paged tick runs
# the hand-written paged-decode kernel, 0 when it runs the plain
# version.  In the port that is 1 for a paged engine on CUDA (the CUDA
# kernels B1/B2 take the Pallas kernels' place) and 0 for a paged
# engine on the CPU (the plain PyTorch versions, the counterpart of the
# reference's jnp fallback); dense engines set 0.
_M_KERNEL_PALLAS = metrics_lib.gauge(
    'skytpu_engine_decode_kernel_pallas',
    'Whether the paged decode attention runs the hand-written kernel '
    '(1) or the plain fallback (0); dense engines set 0.')


def _maybe_page_journal():
    """The serving journal while someone watches page alloc/free (the
    `serve.page_pool` chaos site armed, or SKYTPU_SERVE_PAGE_EVENTS
    set), else None: admissions stay free of I/O."""
    if not (os.environ.get('SKYTPU_SERVE_PAGE_EVENTS') or
            chaos_injector.site_armed('serve.page_pool')):
        return None
    return profiling.serve_journal()


class ContinuousBatchingEngine:
    """Submit() from any thread; one worker thread owns the device."""

    def __init__(self, cfg, model, *, max_len: int = 512,
                 slots: int = 4, prefill_chunk: int = 512,
                 max_queue: int = 0,
                 queue_ttl: Optional[float] = None,
                 max_top_k: int = 64, max_stop_ids: int = 16,
                 pipelined: bool = True,
                 kv_pages: Optional[int] = None, page_size: int = 16,
                 quantize_kv: bool = False,
                 prefix_caching: bool = True,
                 spec_tokens: int = 0,
                 mesh=None,
                 device: Union[str, torch.device] = 'cuda') -> None:
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f'model on {model.device}, engine on '
                             f'{self.device}')
        # A slice replica's mesh (parallel/mesh.py): the state and rank
        # 0's weights and pool live on its first device, the engine's; a
        # tensor axis above 1, or positions on other cards, need a
        # TensorParallel model over the same positions.
        self.mesh = mesh
        if mesh is not None:
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f'mesh devices {mesh.devices} are not '
                                 f'all {self.device.type} devices')
            if mesh.devices[0] != self.device:
                raise ValueError(f'the mesh starts at {mesh.devices[0]}, '
                                 f'the engine is on {self.device}')
            want = (tensor_parallel.mesh_layout(mesh)
                    if tensor_parallel.needs_ranks(mesh, self.device, cfg)
                    else None)
            if tensor_parallel.layout(model) != want:
                raise ValueError(
                    f'the model\'s tensor layout '
                    f'{tensor_parallel.layout(model)} is not the mesh\'s '
                    f'{want}: a mesh with a tensor axis above 1 or '
                    'positions on other cards serves a TensorParallel '
                    'over its positions (convert.to_tensor_parallel)')
        self.spec_tokens = int(spec_tokens)
        if self.spec_tokens < 0:
            raise ValueError(f'spec_tokens must be >= 0, got {spec_tokens}')
        self.cfg = cfg
        self.model = model
        self._weight_epoch = 0
        self.max_len = max_len
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.max_top_k = int(max_top_k)
        self.max_stop_ids = int(max_stop_ids)
        self.pipelined = bool(pipelined)
        self.quantize_kv = bool(quantize_kv)
        self._slots = [scheduler.Slot() for _ in range(slots)]
        self._queue = scheduler.AdmissionQueue(
            max_queue=max_queue, queue_ttl=queue_ttl,
            drain_estimate=self._drain_estimate)
        self._cond = self._queue.cond
        self._stop = threading.Event()
        self._sampler = sampler_lib.SlotSampler(self.max_top_k,
                                                self.max_stop_ids)
        # Closures the worker runs between ticks (`_on_worker`).
        self._host_ops: Deque[Any] = collections.deque()
        self._host_ops_lock = threading.Lock()
        # Each export holds a private prefill cache: at most two at once.
        self._export_sem = threading.BoundedSemaphore(2)
        self._kv: Optional[cache_manager.PagedKVManager] = None
        if kv_pages is not None:
            if not self.pipelined:
                raise ValueError('kv_pages (paged KV cache) requires the '
                                 'pipelined engine')
            if max_len % page_size:
                raise ValueError(
                    f'max_len {max_len} must be a multiple of page_size '
                    f'{page_size} (private prefill caches scatter whole '
                    'pages into the pool)')
            self._kv = cache_manager.PagedKVManager(
                int(kv_pages), int(page_size),
                prefix_caching=prefix_caching,
                journal=_maybe_page_journal())
            self._cache = decode.init_paged_cache(
                cfg, int(kv_pages), int(page_size), slots,
                max_len // int(page_size), quantize_kv=quantize_kv,
                device=self.device, model=model)
            self._step = decode.paged_engine_step
            self._spec_step = decode.paged_spec_engine_step
            self._admit_paged = decode.paged_admit_slot
            self._release_paged = decode.paged_release_slot
            self._insert_pages = decode.insert_prefill_pages
            self._seed_private = decode.paged_seed_private
            self._write_pages = decode.write_pages
            self._write_pages_q = decode.write_pages_quantized
        else:
            if self.spec_tokens:
                raise ValueError(
                    'spec_tokens (speculative decoding) requires the '
                    'paged KV engine (kv_pages): rejected drafts roll '
                    "back through the pool's reserved null page")
            self._cache = decode.init_slot_cache(cfg, slots, max_len,
                                                 device=self.device,
                                                 model=model)
            self._step = decode.engine_step
        # Dense-cache entries (the paged engine keeps them, as the
        # reference does, so both modes list the same sentinel entries).
        self._insert = decode.insert_prefill
        self._legacy_step = decode.batched_step
        self._prefill = decode.prefill
        self._prefill_chunk = decode.prefill_chunk
        self.decode_kernel = 'paged' if self._kv is not None else 'dense'
        _M_KERNEL_PALLAS.set(1 if self._kv is not None and
                             self.device.type == 'cuda' else 0)
        # The profiling plane: the tick-phase ring and the shape sentinel
        # over every step entry above (both no-ops under
        # SKYTPU_PROFILE_DISABLE).  The sentinel sees each call's tensor
        # shapes: prefill and chunk widths and page-write shapes.  A
        # tick's row bucket comes from slots x (k+1) inside the step and
        # is fixed for the engine's life, so the step keeps one
        # signature.
        self._profiler = profiling.TickProfiler(
            memory_cb=profiling.device_memory_cb(self.device))
        self._sentinel = profiling.RecompileSentinel()
        for attr in ('_step', '_spec_step', '_admit_paged',
                     '_release_paged', '_insert_pages', '_seed_private',
                     '_write_pages', '_write_pages_q', '_legacy_step',
                     '_prefill', '_prefill_chunk', '_insert'):
            entry = getattr(self, attr, None)
            if entry is not None:
                setattr(self, attr,
                        self._sentinel.wrap(attr.lstrip('_'), entry))
        # The worker's records carry this identity (the model server
        # sets it) plus the request id it binds around each admission.
        self.log_identity: Optional[Dict[str, Any]] = None
        self._state = decode.init_engine_state(slots, max_stop_ids,
                                               device=self.device)
        self._tokens = torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device)   # legacy loop
        self.stream = None
        if self.device.type == 'cuda':
            self.stream = torch.cuda.Stream(self.device)
            # Its first launch waits for the state made here.
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
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
        # Finished per-request spans, bounded; surfaced via
        # stats()['recent_spans'], span() and GET /spans.
        self._spans = tracing.SpanStore()
        _M_SLOTS.set(slots)
        _M_BUSY_SLOTS.set(0)

        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public

    def submit(self, prompt_ids: List[int], max_new_tokens: int,
               stop_token=None, sampling=None,
               request_id: Optional[str] = None,
               route_meta: Optional[Dict[str, Any]] = None,
               deadline_ms: Optional[float] = None,
               qos_class: Optional[str] = None) -> scheduler.Request:
        """stop_token: None, one id, or an iterable of ids.  sampling: a
        decode.SamplingConfig (temperature <= 0 decodes greedily; a
        seeded request is deterministic whatever else is in flight).
        route_meta: the LB's routing facts, stamped into the span.
        deadline_ms: total time budget from submission.  qos_class: the
        request's QoS class (serve/qos.py): its token budget clamps
        max_new_tokens, its deadline default applies without a deadline
        of the request's own, and queued work pops in weighted class
        order."""
        if not prompt_ids:
            raise ValueError('empty prompt')
        if max_new_tokens < 1:
            raise ValueError(
                f'max_new_tokens must be >= 1, got {max_new_tokens}')
        if len(prompt_ids) + max_new_tokens > self.max_len:
            raise ValueError(
                f'prompt {len(prompt_ids)} + new {max_new_tokens} '
                f'exceeds max_len {self.max_len}')
        self._check_ids(prompt_ids)
        temperature, top_k, seed = sampler_lib.validate_sampling(
            sampling, max_top_k=self.max_top_k, pipelined=self.pipelined)
        request = scheduler.Request(prompt_ids, max_new_tokens, stop_token,
                                    temperature=temperature, top_k=top_k,
                                    seed=seed, request_id=request_id,
                                    route_meta=route_meta,
                                    deadline_ms=deadline_ms,
                                    qos_class=qos_class)
        request._span_store = self._spans  # pylint: disable=protected-access
        # The epoch in force at submit: a swap landing mid-decode still
        # attributes this request to the weights that prefilled it.
        request.span.weight_epoch = self._weight_epoch
        sampler_lib.validate_stop_ids(request.stop_ids, self.max_stop_ids)
        self._check_running()
        if self._kv is not None:
            need = self._kv.pages_needed(len(prompt_ids), max_new_tokens)
            if need > self._kv.pool.capacity:
                raise ValueError(
                    f'request needs {need} KV pages > pool capacity '
                    f'{self._kv.pool.capacity}')
            if len(self._queue) > 0 and not self._kv.can_admit(need):
                raise self._queue.reject(
                    'pages_exhausted',
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

    def _check_ids(self, prompt_ids: List[int]) -> None:
        vocab = self.cfg.vocab_size
        if any(not 0 <= int(t) < vocab for t in prompt_ids):
            raise ValueError(f'prompt ids must lie in [0, {vocab})')

    def _check_running(self) -> None:
        if self._stop.is_set() or self._failed is not None:
            raise RuntimeError('batching engine is stopped'
                               if self._failed is None else
                               f'batching engine failed: {self._failed}')

    # ------------------------------------------------------- host ops

    def _on_worker(self, fn, timeout_error: Exception) -> Any:
        """Run fn() on the worker thread between ticks; return its result
        or raise its error (`timeout_error` when the worker does not get
        to it within 60 s)."""
        self._check_running()
        holder: Dict[str, Any] = {}
        done = threading.Event()

        def op() -> None:
            try:
                if self._stop.is_set():
                    raise RuntimeError('batching engine stopped')
                holder['result'] = fn()
            except BaseException as e:  # pylint: disable=broad-except
                holder['error'] = e
            finally:
                done.set()

        with self._host_ops_lock:
            self._host_ops.append(op)
        with self._cond:
            self._cond.notify_all()
        if not done.wait(timeout=60):
            raise timeout_error
        if 'error' in holder:
            raise holder['error']
        return holder['result']

    def _drain_host_ops(self) -> int:
        ran = 0
        while True:
            with self._host_ops_lock:
                if not self._host_ops:
                    return ran
                op = self._host_ops.popleft()
            op()   # no-raise by construction
            ran += 1

    def swap_params(self, new_model) -> int:
        """Serve `new_model` (a Transformer of this engine's config, on
        its device) from the next tick on, without dropping the KV or an
        in-flight request; returns the new weight epoch.  The assignment
        runs on the worker between ticks, so no tick sees half a swap.
        Unlike the reference, the prefix cache forgets its entries (pages
        a live slot holds stay with it) and prefills begun before the
        swap publish none: a later request must not adopt KV the old
        weights computed.  An engine over tensor ranks takes a
        TensorParallel of its model's layout, or cuts a plain
        Transformer into one (convert.to_tensor_parallel)."""
        if new_model.cfg != self.cfg:
            raise ValueError('swap_params: the new model has another '
                             'config than the engine')
        if new_model.device != self.device:
            raise ValueError(f'swap_params: model on {new_model.device}, '
                             f'engine on {self.device}')
        layout = tensor_parallel.layout(self.model)
        if layout is not None and tensor_parallel.layout(new_model) is None:
            from skypilot_tpu_torch.models import convert  # pylint: disable=import-outside-toplevel
            new_model = convert.to_tensor_parallel(self.cfg, new_model,
                                                   self.model.mesh)
        if tensor_parallel.layout(new_model) != layout:
            raise ValueError(
                f'swap_params: the new model\'s tensor layout '
                f'{tensor_parallel.layout(new_model)} is not the '
                f'engine\'s {layout}')

        if self.stream is not None:
            # The new weights are written before the worker reads them.
            for dev in tensor_parallel.cards(new_model):
                torch.cuda.current_stream(dev).synchronize()

        def swap() -> int:
            if self.stream is not None:
                # The tick in flight still reads the old weights.
                self.stream.synchronize()
            self.model = new_model
            self._weight_epoch += 1
            if self._kv is not None:
                self._kv.prefix.clear()
            return self._weight_epoch

        return self._on_worker(swap, RuntimeError(
            'weight swap timed out waiting for the engine worker'))

    @property
    def weight_epoch(self) -> int:
        return self._weight_epoch

    def set_role_budget(
            self, budget: Optional[scheduler.RoleBudget]) -> bool:
        """Swap the fractional-role budget in place (weights and pools
        untouched): the next admission checks and prefill chunks use it.
        A push older than the budget in force is dropped and False
        returned; None removes the clamp."""
        return self._queue.set_role_budget(budget)

    @property
    def role_budget(self) -> Optional[scheduler.RoleBudget]:
        return self._queue.role_budget

    # ------------------------------------------------------- KV handoff

    def export_prefill(self, prompt_ids: List[int],
                       page_size: Optional[int] = None,
                       binary: bool = False) -> Any:
        """Prefill a prompt into a private cache (never this engine's slot
        pool or page pool) and return its FULL pages, the prefilled
        region [0, n-1), as the handoff wire payload: the JSON/base64
        dict, or with `binary` the octet-stream frame.  int8 pages and
        scales when this engine quantizes KV, f32 otherwise.  The
        sub-page tail is the importer's to prefill."""
        if self.cfg.n_experts > 0:
            raise HandoffError(
                'MoE prefill couples every prompt token through the '
                'capacity dispatch; its KV cannot transfer page-wise')
        self._check_running()
        ps = int(page_size) if page_size else (
            self._kv.page_size if self._kv is not None else 16)
        n = len(prompt_ids)
        if n < 2:
            raise HandoffError('prompt too short to export')
        if n > self.max_len:
            raise HandoffError(f"prompt {n} exceeds this replica's max_len "
                               f'{self.max_len}')
        self._check_ids(prompt_ids)
        full = (n - 1) // ps
        if full < 1:
            raise HandoffError(
                f'prompt {n} holds no full {ps}-token page to export')
        hashes = cache_manager.chunk_hashes(prompt_ids[:n - 1], ps)
        encode = (handoff_lib.encode_binary if binary
                  else handoff_lib.encode_payload)
        with self._export_sem:
            with torch.cuda.stream(self.stream), torch.no_grad():
                cache = self._prefill_private(prompt_ids, n - 1)
                pages = decode.export_private_pages(
                    cache, full, ps, quantize=self.quantize_kv)
                arrays = [t.cpu().numpy() for t in pages]
        payload = encode(hashes[:full], ps, *arrays)
        _M_HANDOFF_EXPORTS.inc()
        return payload

    def _prefill_private(self, prompt_ids: List[int],
                         n_target: int) -> Dict[str, Any]:
        """Prefill tokens [0, n_target) into a fresh private cache
        ([L, 1, h_kv, max_len, d]): the admission path's chunks."""
        cache, consumed = None, 0
        while consumed < n_target:
            cache, consumed = self._prefill_piece(
                prompt_ids, cache, consumed, n_target, self.prefill_chunk)
        return cache

    def import_pages(self, hashes: List[int], page_size: int, k_pages,
                     v_pages, k_scale=None,
                     v_scale=None) -> Tuple[int, int]:
        """Adopt exported pages (numpy [L, n, h_kv, ps, d], f32 or int8
        with f32 scales [L, n, h_kv, ps]) into the pool and publish them
        in the prefix cache under `hashes`, so the request that follows
        adopts them as a prefix hit.  Returns (pages_imported,
        pages_already_cached).  Pool exhaustion raises QueueFull (429 +
        Retry-After); a structural mismatch raises HandoffError."""
        if self._kv is None:
            raise HandoffError('KV import needs a paged engine '
                               '(--kv-pages)')
        if not self._kv.prefix_caching:
            raise HandoffError('KV import needs the prefix cache '
                               '(imports publish pages through it)')
        if self.cfg.n_experts > 0:
            raise HandoffError('MoE engines do not reuse prefix pages')
        if int(page_size) != self._kv.page_size:
            raise HandoffError(f'page_size mismatch: payload {page_size}, '
                               f'pool {self._kv.page_size}')
        if len(hashes) > self._kv.pool.capacity:
            raise HandoffError(f'{len(hashes)} pages exceed pool capacity '
                               f'{self._kv.pool.capacity}')
        quantized = str(getattr(k_pages, 'dtype', '')) == 'int8'
        if quantized and (k_scale is None or v_scale is None):
            raise HandoffError('int8 pages need their scales')
        cfg = self.cfg
        geometry = (cfg.n_layers, len(hashes), cfg.n_kv_heads,
                    self._kv.page_size, cfg.head_dim)
        for name, arr in (('k', k_pages), ('v', v_pages)):
            if tuple(arr.shape) != geometry:
                raise HandoffError(f'{name} pages {tuple(arr.shape)} do '
                                   f'not fit this pool: {geometry}')
        # Chaos: deny -> this replica refuses the pages (the router falls
        # back to a local prefill); delay -> handoff latency on the
        # caller's thread, never the ticks'.
        if chaos_injector.inject('serve.kv_handoff',
                                 pages=len(hashes)) is chaos_injector.DENY:
            _M_HANDOFF_IMPORTS.labels(result='denied').inc()
            raise HandoffRejected('chaos: KV handoff import denied')

        def tensor(arr, cached: int) -> torch.Tensor:
            return torch.from_numpy(np.array(arr[:, cached:]))

        def adopt() -> Tuple[int, int]:
            cached = self._kv.import_prefix_depth(hashes)
            fresh_hashes = list(hashes[cached:])
            if not fresh_hashes:
                return 0, cached
            fresh = self._kv.alloc_pages(len(fresh_hashes))
            try:
                k, v = tensor(k_pages, cached), tensor(v_pages, cached)
                if quantized and self.quantize_kv:
                    # int8 wire -> int8 pool: the bytes land verbatim.
                    self._write_pages_q(
                        self._cache, k, v, tensor(k_scale, cached),
                        tensor(v_scale, cached), fresh)
                else:
                    if quantized:   # int8 wire -> float pool
                        k = k.float() * tensor(k_scale, cached)[..., None]
                        v = v.float() * tensor(v_scale, cached)[..., None]
                    self._write_pages(self._cache, k, v, fresh)
                self._kv.prefix.register(fresh_hashes, fresh)
            finally:
                # register() pinned the published pages; dropping the
                # import's own ref leaves them pin-held (or frees them if
                # anything above raised).
                self._kv.pool.decref(fresh)
            return len(fresh_hashes), cached

        timeout = HandoffError(
            'KV import timed out waiting for the engine worker')
        try:
            result = self._on_worker(adopt, timeout)
        except PagesExhausted:
            _M_HANDOFF_IMPORTS.labels(result='pages_exhausted').inc()
            raise self._queue.reject(
                'pages_exhausted',
                f'KV page pool exhausted for handoff import '
                f'({len(hashes)} page(s) needed); retry later') from None
        except Exception as e:
            _M_HANDOFF_IMPORTS.labels(
                result='timeout' if e is timeout else 'error').inc()
            raise
        _M_HANDOFF_IMPORTS.labels(result='ok').inc()
        return result

    def export_prefix_pages(self, max_pages: int = 64,
                            binary: bool = True) -> Any:
        """The hottest prefix-cache pages as a handoff payload (the
        drain-time handoff to a sibling replica): pool pages, no
        prefill.  Raises HandoffError when there is nothing to export."""
        if self._kv is None:
            raise HandoffError('prefix export needs a paged engine '
                               '(--kv-pages)')
        if not self._kv.prefix_caching:
            raise HandoffError('prefix export needs the prefix cache')

        def gather():
            entries = self._kv.prefix.hot_entries(int(max_pages))
            if not entries:
                raise HandoffError('no cached prefixes to export')
            arrays = decode.read_pages(self._cache,
                                       [p for _, p in entries],
                                       self.quantize_kv)
            return [h for h, _ in entries], [a.cpu().numpy()
                                             for a in arrays]

        hashes, arrays = self._on_worker(gather, HandoffError(
            'prefix export timed out waiting for the engine worker'))
        encode = (handoff_lib.encode_binary if binary
                  else handoff_lib.encode_payload)
        payload = encode(hashes, self._kv.page_size, *arrays)
        _M_HANDOFF_EXPORTS.inc()
        return payload

    # ------------------------------------------------------------ metrics

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
        """Scheduling, cache and decode counters (plain numbers)."""
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
                'pipelined': self.pipelined,
                'paged': self._kv is not None,
                'decode_kernel': self.decode_kernel,
                'quantize_kv': self.quantize_kv,
                'spec_tokens': self.spec_tokens,
                'weight_epoch': self._weight_epoch,
                'deadline_reaped': self._deadline_reaped,
                'device': str(self.device),
                'tensor_degree': tensor_parallel.degree(self.model),
            }
            if self.spec_tokens:
                stats['spec_ticks'] = self._spec_ticks
                stats['spec_proposed_tokens'] = self._spec_proposed
                stats['spec_accepted_tokens'] = self._spec_accepted
                stats['spec_accept_len_mean'] = (
                    round((self._spec_accepted + self._spec_slot_ticks) /
                          self._spec_slot_ticks, 3)
                    if self._spec_slot_ticks else None)
            if self._kv is not None:
                stats['pages_exhausted_deferrals'] = self._page_deferrals
        stats.update(self._queue.stats())
        if self._kv is not None:
            stats.update(self._kv.stats())
        rate = round(self._decode_rate(), 3)
        stats['decode_tokens_per_s'] = rate
        # Per-request phase traces, newest first.
        stats['recent_spans'] = self._spans.recent()
        # Freshen the scrape-time gauges so /metrics agrees with
        # /health whichever is polled.
        _M_SLOTS.set(stats['slots'])
        _M_BUSY_SLOTS.set(busy)
        _M_DECODE_RATE.set(rate)
        return stats

    def span(self, request_id: str) -> Optional[Dict[str, Any]]:
        """The finished span record of a request id (None while the
        request runs or once it aged out of the store)."""
        return self._spans.get(request_id)

    def profile(self) -> Dict[str, Any]:
        """The `GET /profile` snapshot: the tick-phase ring with
        per-phase quantiles, the device-memory watermarks, the
        profiler's modeled self-overhead, and the sentinel's counts per
        step entry."""
        snap = self._profiler.snapshot()
        snap['recompiles'] = self._sentinel.snapshot()
        snap['pipelined'] = self.pipelined
        return snap

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
        if self._kv is not None:
            self._kv.release_all()
        self._drain_host_ops()   # stop is set: queued ops error out

    def _record_tokens(self, n: int) -> None:
        now = time.monotonic()
        with self._metrics_lock:
            self._tokens_generated += n
            self._rate_window.append((now, n))
            while (self._rate_window and
                   now - self._rate_window[0][0] > 10.0):
                self._rate_window.popleft()
        _M_TOKENS.inc(n)
        _M_DECODE_RATE.set(round(self._decode_rate(), 3))

    def _record_chunk(self) -> None:
        _M_PREFILL_CHUNKS.inc()
        with self._metrics_lock:
            self._prefill_chunks += 1

    def _record_reap(self) -> None:
        with self._metrics_lock:
            self._deadline_reaped += 1
        _M_DEADLINE_REAPED.inc()

    def _record_tick(self) -> None:
        with self._metrics_lock:
            self._ticks += 1
        _M_TICKS.inc()
        _M_BUSY_SLOTS.set(sum(1 for s in self._slots if s.active))

    # ------------------------------------------------------------ worker

    def _tokens_tensor(self, ids: List[int], width: int) -> torch.Tensor:
        return tokens_tensor(ids, width, self.device)

    def _pad_row(self, row: List[int]) -> List[int]:
        return list(row) + [0] * (self.max_len // self._kv.page_size -
                                  len(row))

    def _set_length(self, slot_id: int, length: int) -> None:
        """Dense cache: the slot's depth (stale keys past it are masked
        and overwritten by its own steps)."""
        self._cache['lengths'][slot_id] = int(length)

    def _start_admission(self, slot_id: int, request: scheduler.Request
                         ) -> Optional[scheduler.PendingPrefill]:
        """Begin admitting `request` into `slot_id`: a PendingPrefill
        when chunks remain, None when the slot went live directly.
        Raises PagesExhausted BEFORE touching any state."""
        slot = self._slots[slot_id]
        prompt = request.prompt_ids
        n = len(prompt)
        plan = None
        if self._kv is not None:
            # MoE: a shared prefix has no shared KV (the capacity
            # dispatch couples every prompt token); pages still pool.
            plan = self._kv.plan_admission(
                prompt, request.max_new_tokens,
                prefix_ok=self.cfg.n_experts == 0)
            request.span.prefix_hit_pages = plan.prefix_hit_pages
            self._kv.commit(slot_id, plan)
        self._queue.record_admission(request)
        if self.cfg.n_experts > 0:
            self._admit_moe(slot_id, request, plan)
            return None
        if n <= 1 or (plan is not None and plan.n_reuse_tokens >= n - 1):
            # Nothing to prefill: a one-token prompt, or a full prefix
            # hit (the prefilled region [0, n-1) is entirely cached).
            length = 0 if n <= 1 else n - 1
            if plan is not None:
                self._admit_paged(self._cache, slot_id,
                                  self._pad_row(plan.row), length)
            else:
                self._set_length(slot_id, length)
            slot.request = request
            self._activate(slot_id, request, int(prompt[-1]), length)
            return None
        slot.request = request
        pending = scheduler.PendingPrefill(slot_id, request, n - 1)
        pending.plan = plan
        pending.weight_epoch = self._weight_epoch
        return pending

    def _admit_moe(self, slot_id: int, request: scheduler.Request,
                   plan) -> None:
        """MoE admission: pad tokens, the n-1 / last-token split and
        chunk boundaries would all change which tokens the capacity
        dispatch drops, so the WHOLE prompt prefills unpadded in one
        piece (flash attention from index 0) and the first token comes
        from its logits, selected as a tick selects it with the key a
        first tick would draw with; the slot joins at length n."""
        prompt = request.prompt_ids
        n = len(prompt)
        t0 = time.perf_counter()
        logits, pre = self._prefill(self.cfg, self.model,
                                    self._tokens_tensor(prompt, n),
                                    max_len=self.max_len)
        request.span.mark_prefill_chunk(time.perf_counter() - t0)
        if plan is not None:
            n_pages = -(-n // self._kv.page_size)
            self._insert_pages(self._cache, pre, plan.row[:n_pages],
                               first_page=0)
        else:
            self._insert(self._cache, slot_id, pre, n)
        carry, draw = decode.split_keys(torch.tensor(
            self._sampler.key(request.seed), dtype=torch.int64))
        first = self._sampler.sample_one(logits, draw, request.temperature,
                                         request.top_k)
        request._push(first)  # pylint: disable=protected-access
        self._record_tokens(1)
        if request.max_new_tokens <= 1 or first in request.stop_ids:
            request._finish()  # pylint: disable=protected-access
            if plan is not None:
                self._kv.release(slot_id)
            return
        if plan is not None:
            self._admit_paged(self._cache, slot_id, self._pad_row(plan.row),
                              n)
        self._slots[slot_id].request = request
        self._activate(slot_id, request, first, n,
                       remaining=request.max_new_tokens - 1,
                       key=carry.tolist())

    def _prefill_piece(self, prompt_ids: List[int],
                       cache: Optional[Dict[str, Any]], consumed: int,
                       n_target: int,
                       chunk: int) -> Tuple[Dict[str, Any], int]:
        return prefill_piece(self.cfg, self.model, prompt_ids, cache,
                             consumed, n_target, chunk,
                             max_len=self.max_len, device=self.device,
                             prefill=self._prefill,
                             prefill_chunk=self._prefill_chunk)

    def _advance_prefill(self, pending: scheduler.PendingPrefill) -> bool:
        """Run ONE chunk of a pending prefill; True when it completed
        (slot live) or was abandoned."""
        request = pending.request
        if request.cancelled or request.deadline_exceeded():
            if request.cancelled:
                request._finish()  # pylint: disable=protected-access
            else:
                self._record_reap()
                request._finish(DeadlineExceeded(  # pylint: disable=protected-access
                    'request deadline passed mid-prefill'))
            self._slots[pending.slot_id].request = None
            self._release_slot_pages(pending.slot_id)
            return True
        t_chunk0 = time.perf_counter()
        plan = pending.plan
        if (pending.cache is None and plan is not None and
                plan.n_reuse_tokens > 0):
            # Prefix hit: positions [0, reuse) come from the pool.
            pending.cache = self._seed_private(
                self.cfg, self._cache, plan.reuse_pages,
                priv_len=self.max_len)
            pending.consumed = plan.n_reuse_tokens
            request.span.mark_prefill_chunk(time.perf_counter() - t_chunk0)
            return False
        # The role budget's clamp (floor 1): a decode-heavy budget makes
        # the pieces smaller, so the prefill slows and never stalls.
        # Exports (`_prefill_private`) are not clamped, as in the
        # reference.
        pending.cache, pending.consumed = self._prefill_piece(
            request.prompt_ids, pending.cache, pending.consumed,
            pending.n_target,
            self._queue.prefill_tokens_per_tick(self.prefill_chunk))
        request.span.mark_prefill_chunk(time.perf_counter() - t_chunk0)
        self._record_chunk()
        self._profiler.lap('prefill-chunk')
        if pending.consumed < pending.n_target:
            return False
        return self._finish_prefill(pending)

    def _finish_prefill(self, pending: scheduler.PendingPrefill) -> bool:
        """Adopt the private cache (paged: scatter the fresh prompt
        pages, point the block table at the full row, publish the pages
        for prefix reuse; dense: copy it into the slot) and join the
        next tick at length n-1."""
        request = pending.request
        plan = pending.plan
        if plan is not None:
            ps = self._kv.page_size
            r = len(plan.reuse_pages)
            n_prompt_pages = -(-pending.n_target // ps)
            self._insert_pages(self._cache, pending.cache,
                               plan.row[r:n_prompt_pages], first_page=r)
            self._admit_paged(self._cache, pending.slot_id,
                              self._pad_row(plan.row), pending.n_target)
            if pending.weight_epoch == self._weight_epoch:
                self._kv.register_prefix(plan)
        else:
            self._insert(self._cache, pending.slot_id, pending.cache,
                         pending.n_target)
        pending.cache = None
        self._activate(pending.slot_id, request,
                       int(request.prompt_ids[-1]), pending.n_target)
        # Cache adoption and activation: a phase of its own, so prefill
        # compute and pool surgery separate.
        self._profiler.lap('page-scatter')
        return True

    def _activate(self, slot_id: int, request: scheduler.Request,
                  token: int, length: int, *,
                  remaining: Optional[int] = None, key=None) -> None:
        """Flip a slot live: `token` is its next tick input (prompt[-1],
        or the MoE first token from prefill), `length` the slot's depth
        (set by the admission paths; the slice engine broadcasts it),
        `remaining` and `key` default to a request with nothing
        generated yet."""
        del length
        if self.spec_tokens:
            # The history ends with the token the next tick feeds.
            self._slots[slot_id].drafter = sampler_lib.NgramDrafter(
                list(request.prompt_ids) + list(request.tokens))
        self._state = self._sampler.admit(
            self._state, slot_id, token,
            request.max_new_tokens if remaining is None else remaining,
            request.stop_ids,
            self._sampler.key(request.seed) if key is None else key,
            request.temperature, request.top_k)

    def _deactivate(self, slot_ids: List[int]) -> None:
        active = self._state['active'].clone()
        active[slot_ids] = False
        self._state = dict(self._state, active=active)

    def _release_slot_pages(self, slot_id: int) -> None:
        """Paged: park the slot's table on the null page, THEN free its
        pages."""
        if self._kv is None:
            return
        self._release_paged(self._cache, slot_id)
        self._kv.release(slot_id)

    def _finish_slot(self, slot_id: int, live: Dict[int, Any]) -> None:
        live.pop(slot_id, None)
        self._slots[slot_id].request = None
        self._slots[slot_id].drafter = None
        self._release_slot_pages(slot_id)

    def _dispatch_step(self):
        """Dispatch one engine tick.  The slice engine
        (serve/slice_replica.py) overrides this to broadcast the tick
        through its rank coordinator first: every rank of a slice
        dispatches the same step in lockstep."""
        return self._step(self.cfg, self.model, self._state, self._cache,
                          max_top_k=self.max_top_k)

    def _dispatch_spec_step(self, drafts: torch.Tensor):
        """Dispatch one speculative verify tick on the host's draft
        batch [slots, k] (the slice engine broadcasts it, exactly like
        `_dispatch_step`)."""
        return self._spec_step(self.cfg, self.model, self._state,
                               self._cache, drafts.to(self.device),
                               max_top_k=self.max_top_k)

    def _spec_tick(self, live: Dict[int, scheduler.Request]) -> None:
        """One synchronous speculative tick (see module docstring)."""
        k = self.spec_tokens
        n_live = len(live)
        drafts = torch.zeros((len(self._slots), k), dtype=torch.int32)
        for slot_id in live:
            drafter = self._slots[slot_id].drafter
            if drafter is not None:
                drafts[slot_id] = torch.tensor(drafter.propose(k),
                                               dtype=torch.int32)
        self._state, self._cache, finished, toks_d, counts_d = (
            self._dispatch_spec_step(drafts))
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
            span = request.span
            span.spec_steps += 1
            span.spec_proposed += k
            span.spec_accepted += max(c - 1, 0)
            _M_SPEC_ACCEPT_LEN.observe(float(max(c, 1)))
            if fins[slot_id]:
                self._finish_slot(slot_id, live)
                request._finish()  # pylint: disable=protected-access
        if pushed:
            self._record_tokens(pushed)
        with self._metrics_lock:
            self._spec_ticks += 1
            self._spec_slot_ticks += slot_ticks
            self._spec_proposed += k * n_live
            self._spec_accepted += accepted
        _M_SPEC_PROPOSED.inc(k * n_live)
        _M_SPEC_ACCEPTED.inc(accepted)
        self._record_tick()

    def _run(self) -> None:
        # One tick_profile start/end pair brackets a pipelined worker's
        # run, so a journal replay can attribute the ring's ticks to an
        # engine incarnation and see whether it failed or drained.
        journal = None
        if self.pipelined:
            try:
                journal = profiling.serve_journal()
                journal.append('tick_profile_start',
                               ring_ticks=self._profiler.ring_ticks,
                               enabled=not self._profiler.disabled)
            except Exception:  # pylint: disable=broad-except
                journal = None
        try:
            if self.device.type == 'cuda':
                torch.cuda.set_device(self.device)
            with torch.cuda.stream(self.stream), torch.no_grad():
                if self.pipelined:
                    self._run_pipelined()
                else:
                    self._run_legacy()
        except Exception as e:  # pylint: disable=broad-except
            # The cache may be half-written: fail everything in flight,
            # refuse new submits, and exit the worker.
            logger.exception('batching engine tick failed')
            self._fail_everything(e)
        finally:
            if journal is not None:
                journal.append(
                    'tick_profile_end',
                    status='error' if self._failed is not None else 'ok',
                    ticks=self._profiler.ticks)

    def _idle_wait(self) -> None:
        """Sleep until a submit, a host op or stop (at most 50 ms)."""
        with self._cond:
            with self._host_ops_lock:
                ops_waiting = bool(self._host_ops)
            if (not len(self._queue) and not ops_waiting and
                    not self._stop.is_set()):
                self._cond.wait(timeout=0.05)

    def _run_pipelined(self) -> None:
        # One in-flight tick: (state, finished, [(slot, request)]),
        # read one tick behind.
        inflight: Optional[Tuple[Any, Any, List[Tuple[int, Any]]]] = None
        pending_prefills: Deque[scheduler.PendingPrefill] = (
            collections.deque())
        live: Dict[int, scheduler.Request] = {}
        prof = self._profiler
        while not self._stop.is_set():
            prof.begin_tick()
            self._queue.expire_stale()
            # Host ops (KV imports, exports, swaps) run between ticks.
            ran_ops = self._drain_host_ops()
            prof.lap('handoff', record=bool(ran_ops))
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
                        self._record_reap()
                        request._finish(DeadlineExceeded(  # pylint: disable=protected-access
                            'request deadline passed mid-generation'))
            # Admissions; page-pool exhaustion DEFERS the request.
            deferred = admitted = False
            free = [i for i, s in enumerate(self._slots) if not s.active]
            occupied = len(self._slots) - len(free)
            for slot_id in free:
                # The role budget's decode cap: no admission once the
                # occupied slots reach it (queued requests keep their
                # order; running decodes finish).
                if not self._queue.admission_allowed(occupied):
                    break
                request = self._queue.pop()
                if request is None:
                    break
                admitted = True
                try:
                    # Worker-side log records carry the request's id.
                    with logs_lib.bind(request_id=request.request_id,
                                       **(self.log_identity or {})):
                        pending = self._start_admission(slot_id, request)
                except PagesExhausted:
                    self._queue.requeue_front(request)
                    with self._metrics_lock:
                        self._page_deferrals += 1
                    deferred = True
                    break
                if pending is not None:
                    pending_prefills.append(pending)
                elif self._slots[slot_id].request is not None:
                    live[slot_id] = request
                else:
                    continue   # finished at admission (MoE, one token)
                occupied += 1
            # The admit phase: stale expiry, reaps and admissions.
            prof.lap('admit', record=bool(admitted or deferred or reaped))
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
                prof.lap('spec-verify')
            elif live:
                self._state, self._cache, finished = self._dispatch_step()
                dispatched = (self._state, finished, list(live.items()))
                prof.lap('decode-step')
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
                self._record_tick()
                # The host sync above: this lap carries the wait for
                # the device.
                prof.lap('sample')
            inflight = dispatched
            prof.end_tick()
            if inflight is None and not live and not pending_prefills:
                if deferred:
                    time.sleep(0.005)
                else:
                    self._idle_wait()

    # --------------------------------------------------- legacy worker

    def _admit_legacy(self, slot_id: int,
                      request: scheduler.Request) -> None:
        """Un-pipelined admission: the WHOLE prompt prefills inline (one
        stall for every running request).  Dense cache only."""
        if request.cancelled:
            request._finish()  # pylint: disable=protected-access
            return
        slot = self._slots[slot_id]
        prompt = request.prompt_ids
        n = len(prompt)
        if self.cfg.n_experts > 0:
            # MoE: the whole prompt unpadded (`_admit_moe`); the first
            # token is the argmax of its logits.
            logits, pre = self._prefill(self.cfg, self.model,
                                        self._tokens_tensor(prompt, n),
                                        max_len=self.max_len)
            self._profiler.lap('prefill-chunk')
            self._insert(self._cache, slot_id, pre, n)
            self._profiler.lap('page-scatter')
            first = int(torch.argmax(logits[0]))
            request._push(first)  # pylint: disable=protected-access
            self._record_tokens(1)
            if request.max_new_tokens <= 1 or first in request.stop_ids:
                request._finish()  # pylint: disable=protected-access
                return
            slot.request = request
            slot.next_token = first
            return
        if n > 1:
            bucket = min(prefill_bucket(n - 1), self.max_len)
            _, pre = self._prefill(
                self.cfg, self.model,
                self._tokens_tensor(prompt[:-1], bucket),
                max_len=self.max_len)
            self._profiler.lap('prefill-chunk')
            self._insert(self._cache, slot_id, pre, n - 1)
            self._profiler.lap('page-scatter')
        else:
            self._set_length(slot_id, 0)
        slot.request = request
        slot.next_token = int(prompt[-1])

    def _tick_legacy(self) -> None:
        """Un-pipelined tick: per-slot token staging, one host sync per
        generated token, greedy only.  Laps: decode-step after the
        dispatch, sample after the host sync and bookkeeping (the
        reference's legacy loop records none; these are the phases its
        pipelined loop uses for the same work)."""
        for slot in self._slots:
            request = slot.request
            if request is None:
                continue
            if request.cancelled:
                slot.request = None
                request._finish()  # pylint: disable=protected-access
            elif request.deadline_exceeded():
                slot.request = None
                self._record_reap()
                request._finish(DeadlineExceeded(  # pylint: disable=protected-access
                    'request deadline passed mid-generation'))
        active = [i for i, s in enumerate(self._slots) if s.active]
        if not active:
            return
        tokens = self._tokens.clone()
        for i in active:
            tokens[i, 0] = self._slots[i].next_token
        logits, self._cache = self._legacy_step(self.cfg, self.model,
                                                tokens, self._cache)
        self._profiler.lap('decode-step')
        nxt = torch.argmax(logits, dim=-1).tolist()   # the host sync
        for i in active:
            slot = self._slots[i]
            request = slot.request
            token = int(nxt[i])
            request._push(token)  # pylint: disable=protected-access
            if (len(request.tokens) >= request.max_new_tokens or
                    token in request.stop_ids):
                slot.request = None
                request._finish()  # pylint: disable=protected-access
            else:
                slot.next_token = token
        self._tokens = tokens
        self._record_tokens(len(active))
        self._record_tick()
        self._profiler.lap('sample')

    def _run_legacy(self) -> None:
        prof = self._profiler
        while not self._stop.is_set():
            prof.begin_tick()
            self._queue.expire_stale()
            ran_ops = self._drain_host_ops()
            prof.lap('handoff', record=bool(ran_ops))
            idle = not any(s.active for s in self._slots)
            admitted = False
            for slot_id in [i for i, s in enumerate(self._slots)
                            if not s.active]:
                request = self._pop_admitted()
                if request is None and idle:
                    # The wait is no tick's work: close the tick (its
                    # host ops stay recorded) and start another after.
                    prof.end_tick()
                    self._idle_wait()
                    prof.begin_tick()
                    request = self._pop_admitted()
                if request is None:
                    break
                admitted = True
                try:
                    with logs_lib.bind(request_id=request.request_id,
                                       **(self.log_identity or {})):
                        self._admit_legacy(slot_id, request)
                    idle = False
                except Exception as e:  # pylint: disable=broad-except
                    request._finish(e)  # pylint: disable=protected-access
            prof.lap('admit', record=admitted)
            self._tick_legacy()
            prof.end_tick()

    def _pop_admitted(self) -> Optional[scheduler.Request]:
        request = self._queue.pop()
        if request is not None:
            self._queue.record_admission(request)
        return request

    # ------------------------------------------------------------ failure

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
        if self._kv is not None:
            self._kv.release_all()
        self._drain_host_ops()   # stop is set: queued ops error out
