"""A check for the card: the observability plane adds no device work.

`same_device_work(engine, tokens)` runs a paged CUDA engine's
sentinel-wrapped step and prefill, between a TickProfiler's
begin_tick / lap / end_tick, against the bare entries (`__wrapped__`)
on identical inputs, in the caller's thread: clones of the idle
engine's cache and state, every slot forced live on pages of its own.
Both runs make the same calls, so their kernels (the multiset most
per-call profiler windows agree on), their B1/B2/B3 launches and their
tokens must be equal; nothing here depends on the worker thread's
timing.  `chip_smoke.py` runs it at llama3-8b and
`tests/test_torch_kernels_gpu.py` at the `small` preset.

This module uses torch.profiler and synchronises the device; it is a
check, not part of the plane (`observability/` does neither).
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List

import torch

from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.observability import profiling
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import paged_attention

WARMUP_CALLS = 2


def settle(engine) -> None:
    """Return once the worker has read its last tick: two host ops run
    at the top of two worker iterations, the second after any tick the
    first found in flight; then the engine's stream is drained."""
    for _ in range(2):
        engine._on_worker(lambda: None, RuntimeError('engine worker stuck'))  # pylint: disable=protected-access
    if engine.stream is not None:
        engine.stream.synchronize()


def clone_tree(tree):
    """A copy of a dict tree whose tensors are cloned."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def is_kernel_event(e) -> bool:
    """A profiler event that ran on the card; a user annotation spans
    kernels that are counted alone."""
    return (e.device_type == torch.autograd.DeviceType.CUDA and
            not getattr(e, 'is_user_annotation', False))


def agreed_kernels(per_call: List[collections.Counter], what: str):
    """(the kernel-name multiset most of `per_call` launched, how many
    windows saw another), for one profiler window a call of identical
    calls.  torch.profiler's device records are not exact per window: a
    window can miss a record or hold one of its neighbour's (both seen
    on the H100 at llama3-8b, with and without the plane), so the
    multiset is the one a majority of windows agree on."""
    votes = collections.Counter(tuple(sorted(c.items())) for c in per_call)
    key, agree = votes.most_common(1)[0]
    agreed = collections.Counter(dict(key))
    if not agreed or 2 * agree <= len(per_call):
        raise AssertionError(f'{what}: no kernel multiset shared by most '
                             f'calls ({agree} of {len(per_call)})')
    return agreed, len(per_call) - agree


def _launches():
    return (paged_attention.LAUNCHES['paged_attention'],
            paged_attention.LAUNCHES['paged_attention_int8'],
            attention.LAUNCHES['flash_fwd'])


def same_device_work(engine, tokens: torch.Tensor,
                     calls: int = 8) -> Dict[str, Any]:
    """Hold the wrapped step + prefill to the bare ones (see the module
    docstring); `tokens` [1, n] is the prefill's prompt.  Raises
    AssertionError if the kernel multisets, the B1/B2/B3 launches (one
    paged launch a layer a step, one B3 a layer a prefill) or the
    tokens differ.  Returns {'kernels_per_call', 'distinct_kernels',
    'launches', 'windows_off_majority', 'ticks'}."""
    cfg, model = engine.cfg, engine.model
    settle(engine)
    state = clone_tree(engine._state)  # pylint: disable=protected-access
    cache = clone_tree(engine._cache)  # pylint: disable=protected-access
    slots = state['active'].numel()
    state['active'][:] = True
    state['remaining'][:] = engine.max_len
    # Every slot live on pages of its own (a freed slot's table points
    # at the null page, which live slots would all write at once).
    per_slot = engine.max_len // engine._kv.page_size  # pylint: disable=protected-access
    for slot in range(slots):
        decode.paged_admit_slot(
            cache, slot, list(range(1 + slot * per_slot,
                                    1 + (slot + 1) * per_slot)),
            engine.max_len // 8 + slot * (engine.max_len // (4 * slots)))
    step, prefill = engine._step, engine._prefill  # pylint: disable=protected-access
    ticks = profiling.TickProfiler(
        disabled=False, memory_cb=profiling.device_memory_cb(tokens.device))

    def call(plane, st, pool):
        if plane:
            ticks.begin_tick()
        st, pool, _ = (step if plane else step.__wrapped__)(
            cfg, model, st, pool)
        if plane:
            ticks.lap('decode-step')
        (prefill if plane else prefill.__wrapped__)(
            cfg, model, tokens, max_len=engine.max_len)
        if plane:
            ticks.lap('prefill-chunk')
            ticks.end_tick()
        return st, pool

    for plane in (False, True):   # warm-up: lazy allocations, first loads
        st, pool = clone_tree(state), clone_tree(cache)
        for _ in range(WARMUP_CALLS):
            st, pool = call(plane, st, pool)
    del st, pool
    result = {}
    for plane in (False, True):
        st, pool = clone_tree(state), clone_tree(cache)
        torch.cuda.synchronize()
        before = _launches()
        per_call, out = [], []
        for _ in range(calls):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                st, pool = call(plane, st, pool)
                torch.cuda.synchronize()
            per_call.append(collections.Counter(
                e.name for e in prof.events() if is_kernel_event(e)))
            out.append(st['tokens'])
        agreed, noisy = agreed_kernels(per_call, f'plane={plane}')
        result[plane] = {
            'per_call': agreed, 'windows_off_majority': noisy,
            'launches': tuple(a - b for a, b in zip(_launches(), before)),
            'tokens': torch.stack(out)}
        del st, pool
    off, on = result[False], result[True]
    if on['per_call'] != off['per_call']:
        diff = collections.Counter(on['per_call'])
        diff.subtract(off['per_call'])
        raise AssertionError(f'the plane changed the kernels of a call: '
                             f'{ {k: v for k, v in diff.items() if v} }')
    n = calls * cfg.n_layers
    expected = (0, n, n) if engine.quantize_kv else (n, 0, n)
    if on['launches'] != off['launches'] or on['launches'] != expected:
        raise AssertionError(f'B1/B2/B3 launches with the plane '
                             f'{on["launches"]}, without {off["launches"]}'
                             f', expected {expected}')
    if not torch.equal(on['tokens'], off['tokens']):
        raise AssertionError('the plane changed the tokens of the step')
    recorded = ticks.snapshot()['ticks']
    if recorded != WARMUP_CALLS + calls:
        raise AssertionError(f'the wrapped run recorded {recorded} ticks, '
                             f'not {WARMUP_CALLS + calls}')
    return {'kernels_per_call': sum(on['per_call'].values()),
            'distinct_kernels': len(on['per_call']),
            'launches': on['launches'],
            'windows_off_majority': (off['windows_off_majority'] +
                                     on['windows_off_majority']),
            'ticks': recorded}
