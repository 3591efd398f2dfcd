"""Slice-serving runtime: one replica = one gang of ranks (mirrors
`skypilot_tpu/serve/slice_replica.py`).

- **Mesh.**  `build_slice_mesh(num_hosts, cfg)` lays the slice out as
  `sequence x tensor` over a device list (parallel/mesh.py), position
  (r, t) at r * tensor + t as the reference's mesh orders its devices.
  `slice_axes` factors the hosts exactly as the reference does: by
  default the tensor factor takes the largest divisor of the hosts the
  config's shapes allow.  A tensor factor above 1, or ranks on distinct
  cards, serve a `TensorParallel` model over the mesh
  (models/tensor_parallel.py: per-rank weight shards, a pool per
  tensor rank, one copy of the shards on each further card); the
  engine cuts a plain model into one.  The list may repeat one card:
  four entries of `cuda:0` are four emulated hosts, the counterpart of
  the reference's virtual CPU devices.
- **Gang.**  :class:`SliceReplicaEngine` wraps the continuous-batching
  engine with the rank protocol (`serve/coordinator.py`): rank 0
  broadcasts every host-side scheduling decision (admit, release,
  tick, with the draft batch of a speculative tick) before it
  dispatches, and one dead rank fails the replica AS A UNIT: the
  engine fails everything in flight and `/health` turns 503 with
  `slice.degraded`.
- **Sequence-parallel prefill.**  A prompt at or above `sp_threshold`
  tokens skips the chunked-prefill ladder and runs ONE
  `models/decode.prefill_sp` call: ring attention
  (`ops/ring_attention.py`) over the mesh's sequence axis, B3 per hop
  (once per tensor rank, at its heads).

Ranks: emulated followers are `LocalRank` threads; a
:class:`FollowerExecutor` given to one replays the command log through
the port's single-device functions on its own device, and
`follower_main` runs one behind a TCP connection to rank 0 (`python -m
skypilot_tpu_torch.serve.slice_replica --rank N --coordinator
host:port`).  As in the reference, a follower replays the CHUNKED
prefill of every admission; CMD_PREFILL only reports an SP prefill.
"""
from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Union

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import batching_engine as batching_engine_lib
from skypilot_tpu_torch.serve import coordinator as coordinator_lib
from skypilot_tpu_torch.serve import sampler as sampler_lib

logger = logging.getLogger(__name__)

# Port offset from the gang coordinator address for the rank protocol
# (the reference's, so one gang env contract serves both).
SLICE_COORD_PORT_OFFSET = 17


def sp_threshold_default() -> int:
    """Prompt tokens at which a slice replica prefills sequence-
    parallel instead of chunked (env SKYTPU_SLICE_SP_THRESHOLD)."""
    return int(os.environ.get('SKYTPU_SLICE_SP_THRESHOLD', '1024'))


def slice_axes(num_hosts: int, cfg,
               tensor: Optional[int] = None,
               sequence: Optional[int] = None) -> Dict[str, int]:
    """Factor a slice's hosts into (sequence, tensor) mesh axes.

    Default policy: tensor takes the LARGEST divisor of num_hosts the
    config's shapes support (n_heads, n_kv_heads, d_ff, vocab_size all
    divisible) and the remainder rides 'sequence'.  Either factor can
    be pinned explicitly (``--slice-sequence`` / ``--slice-tensor``);
    they must multiply to num_hosts.  (The reference's policy and
    errors, unchanged.)
    """
    if num_hosts < 1:
        raise ValueError(f'num_hosts must be >= 1, got {num_hosts}')
    if tensor is not None and sequence is not None:
        if tensor * sequence != num_hosts:
            raise ValueError(
                f'sequence ({sequence}) x tensor ({tensor}) must equal '
                f'num_hosts ({num_hosts})')
        return {'sequence': int(sequence), 'tensor': int(tensor)}
    if sequence is not None:
        if num_hosts % sequence:
            raise ValueError(f'sequence ({sequence}) must divide '
                             f'num_hosts ({num_hosts})')
        return {'sequence': int(sequence),
                'tensor': num_hosts // int(sequence)}
    if tensor is None:
        tensor = 1
        for d in range(1, num_hosts + 1):
            if num_hosts % d:
                continue
            if (cfg.n_heads % d or cfg.n_kv_heads % d or
                    cfg.d_ff % d or cfg.vocab_size % d):
                continue
            tensor = d
    if num_hosts % tensor:
        raise ValueError(f'tensor ({tensor}) must divide num_hosts '
                         f'({num_hosts})')
    for dim, value in (('n_heads', cfg.n_heads),
                       ('n_kv_heads', cfg.n_kv_heads),
                       ('d_ff', cfg.d_ff),
                       ('vocab_size', cfg.vocab_size)):
        if value % tensor:
            raise ValueError(
                f'tensor={tensor} must divide {dim} ({value}); pin '
                f'--slice-sequence to keep more hosts on the sequence '
                f'axis')
    return {'sequence': num_hosts // int(tensor), 'tensor': int(tensor)}


def build_slice_mesh(num_hosts: int, cfg, *, devices=None,
                     tensor: Optional[int] = None,
                     sequence: Optional[int] = None,
                     device: Union[str, torch.device] = 'cuda'
                     ) -> mesh_lib.Mesh:
    """The `sequence x tensor` Mesh of one slice replica over its first
    `num_hosts` devices, row-major (position r * tensor + t is sequence
    rank r, tensor rank t, as in the reference's mesh).  `devices=None`
    takes the visible CUDA devices (raising without CUDA, or with fewer
    than num_hosts), or with device='cpu' num_hosts CPU entries (the
    emulated hosts); an explicit list may repeat one device."""
    axes = slice_axes(num_hosts, cfg, tensor=tensor, sequence=sequence)
    if devices is None:
        dev = resolve_device(device)
        if dev.type == 'cpu':
            devices = [dev] * num_hosts
        else:
            devices = [torch.device('cuda', i)
                       for i in range(torch.cuda.device_count())]
    if len(devices) < num_hosts:
        raise ValueError(
            f'num_hosts={num_hosts} needs {num_hosts} devices; have '
            f'{len(devices)} (pass devices= to emulate hosts on a '
            f'repeated device)')
    return mesh_lib.Mesh(list(devices)[:num_hosts], axes)


class SliceReplicaEngine(batching_engine_lib.ContinuousBatchingEngine):
    """Continuous-batching engine whose replica is a slice: (a) the slice
    mesh, whose first device holds the state and rank 0's weights and
    pool (a TensorParallel model over the mesh when it has a tensor
    factor above 1 or ranks on other cards: a plain model is cut into
    one);
    (b) the rank protocol: every tick, admission and release broadcasts
    through the SliceCoordinator before rank 0 dispatches, and a dead
    rank fails the replica as a unit; (c) sequence-parallel prefill for
    prompts of at least `sp_threshold` tokens."""

    def __init__(self, cfg, model, *, num_hosts: int,
                 sp_threshold: Optional[int] = None,
                 sequence: Optional[int] = None,
                 tensor: Optional[int] = None,
                 mesh=None,
                 rank_channels: Optional[List[Any]] = None,
                 device: Union[str, torch.device] = 'cuda',
                 **kwargs) -> None:
        self.num_hosts = int(num_hosts)
        self.sp_threshold = (sp_threshold_default()
                             if sp_threshold is None
                             else int(sp_threshold))
        if mesh is None:
            mesh = build_slice_mesh(self.num_hosts, cfg, sequence=sequence,
                                    tensor=tensor, device=device)
        if (tensor_parallel.layout(model) is None and
                tensor_parallel.needs_ranks(mesh, model.device, cfg)):
            model = convert.to_tensor_parallel(cfg, model, mesh)
        self._slice_mesh = mesh
        self._sp_degree = int(mesh.shape.get('sequence', 1))
        self._coordinator = coordinator_lib.SliceCoordinator(
            self.num_hosts, channels=rank_channels)
        self._sp_prefills = 0
        self._sp_prefill = functools.partial(
            decode.prefill_sp, cfg, mesh=mesh,
            max_len=kwargs.get('max_len', 512))
        try:
            super().__init__(cfg, model, mesh=mesh, device=device,
                             **kwargs)
        except Exception:
            self._coordinator.close()
            raise
        self._sp_prefill = self._sentinel.wrap('sp_prefill',
                                               self._sp_prefill)

    # --------------------------------------------------- gang protocol

    def _dispatch_step(self):
        """Coordinated tick: broadcast TICK and wait for every rank's ack
        (the `slice-sync` lap), then dispatch.  RankDead propagates to
        the worker loop, which fails the replica as a unit."""
        self._coordinator.tick()
        self._profiler.lap('slice-sync')
        return super()._dispatch_step()

    def _dispatch_spec_step(self, drafts: torch.Tensor):
        """Coordinated speculative verify tick: the draft batch (a host
        tensor) rides the TICK payload, so a follower dispatches the
        identical spec step."""
        self._coordinator.broadcast(coordinator_lib.CMD_TICK,
                                    spec=drafts.tolist())
        self._profiler.lap('slice-sync')
        return super()._dispatch_spec_step(drafts)

    def _activate(self, slot_id, request, token, length, *,
                  remaining=None, key=None) -> None:
        """Slot activation broadcasts the FULL admission so a follower
        can mirror it: the prompt (it replays the prefill), the page
        row rank 0's planner allocated, and the slot's decode state
        (token, budget, stop set, key, sampling parameters)."""
        if remaining is None:
            remaining = request.max_new_tokens
        if key is None:
            key = self._sampler.key(request.seed)
        row = (self._kv.slot_row(slot_id)
               if self._kv is not None else None)
        self._coordinator.broadcast(
            coordinator_lib.CMD_ADMIT, slot=slot_id,
            tokens=len(request.prompt_ids),
            prompt=[int(t) for t in request.prompt_ids],
            length=int(length), token=int(token),
            remaining=int(remaining),
            stop_ids=sorted(int(s) for s in request.stop_ids),
            key=[int(x) for x in key],
            temperature=float(request.temperature),
            top_k=int(request.top_k), row=row,
            request_id=request.request_id)
        request.span.slice_sync_ms = round(
            self._coordinator.sync_ms_mean(), 4)
        super()._activate(slot_id, request, token, length,
                          remaining=remaining, key=key)

    def _release_slot_pages(self, slot_id) -> None:
        """A release is a coordinated command too: followers park the
        slot's block table on the null page exactly when rank 0 does."""
        if self._kv is not None:
            self._coordinator.broadcast(coordinator_lib.CMD_RELEASE,
                                        slot=slot_id)
        super()._release_slot_pages(slot_id)

    # ------------------------------------------------------ SP prefill

    def _sp_padded_width(self, n_target: int) -> Optional[int]:
        """Padded prompt width for the one-shot SP prefill: the bucket
        of n_target, rounded up to a multiple of the sequence degree,
        capped at max_len.  None = does not fit; use the chunked
        path."""
        sp = self._sp_degree
        width = min(batching_engine_lib.prefill_bucket(n_target),
                    self.max_len)
        width = -(-width // sp) * sp
        if width > self.max_len:
            width = -(-n_target // sp) * sp
        if width > self.max_len:
            return None
        return width

    def _try_sp_prefill(self, prompt_ids: List[int],
                        n_target: int) -> Optional[Dict[str, Any]]:
        """One-shot sequence-parallel prefill of [0, n_target), or None
        when the prompt takes the chunked path (below the threshold, an
        MoE model, or the padding does not fit).  An MoE prompt takes
        the base engine's chunked MoE prefill, which followers replay:
        the capacity dispatch couples every prompt token, so it cannot
        split over the sequence axis."""
        if n_target < self.sp_threshold or self.cfg.n_experts > 0:
            return None
        width = self._sp_padded_width(n_target)
        if width is None:
            return None
        cache = self._sp_prefill(
            self.model, self._tokens_tensor(prompt_ids[:n_target], width))
        with self._metrics_lock:
            self._sp_prefills += 1
        return dict(cache, index=n_target)

    def _advance_prefill(self, pending) -> bool:
        request = pending.request
        reuse = (pending.plan.n_reuse_tokens
                 if pending.plan is not None else 0)
        if (pending.cache is None and reuse == 0 and
                not request.cancelled):
            t0 = time.perf_counter()
            cache = self._try_sp_prefill(request.prompt_ids,
                                         pending.n_target)
            if cache is not None:
                pending.cache = cache
                pending.consumed = pending.n_target
                request.span.mark_prefill_chunk(time.perf_counter() - t0)
                self._record_chunk()
                self._profiler.lap('prefill-chunk')
                self._coordinator.broadcast(
                    coordinator_lib.CMD_PREFILL,
                    slot=pending.slot_id, tokens=pending.n_target,
                    sp=self._sp_degree)
                return self._finish_prefill(pending)
        return super()._advance_prefill(pending)

    def _prefill_private(self, prompt_ids: List[int],
                         n_target: int) -> Dict[str, Any]:
        """Export-side prefill (`export_prefill`): long prompts go
        sequence-parallel here too."""
        cache = self._try_sp_prefill(prompt_ids, n_target)
        if cache is not None:
            return cache
        return super()._prefill_private(prompt_ids, n_target)

    # ----------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        stats = super().stats()
        slice_stats = self._coordinator.stats()
        with self._metrics_lock:
            slice_stats['sp_prefills'] = self._sp_prefills
        slice_stats['sp_degree'] = self._sp_degree
        slice_stats['tensor_degree'] = int(
            self._slice_mesh.shape.get('tensor', 1))
        slice_stats['sp_threshold'] = self.sp_threshold
        stats['num_hosts'] = self.num_hosts
        stats['slice'] = slice_stats
        return stats

    def stop(self) -> None:
        super().stop()
        self._coordinator.close()


# ------------------------------------------------------------ followers


class FollowerExecutor:
    """Execute rank 0's command log on a follower's own device state.

    A follower holds the same weights and engine geometry as rank 0
    (a TensorParallel model replays every tensor rank, each into its own
    pool);
    every broadcast carries rank 0's host-side decision (which slot,
    which pages, which drafts), so replaying the log through the same
    functions reproduces rank 0's state: the sampler state and block
    tables bit for bit, the pool up to the float rounding of the
    prefill path (rank 0 may have prefilled sequence-parallel).

    - ``TICK``: one engine step; a ``spec`` payload (the draft batch)
      selects the speculative verify tick.
    - ``ADMIT``: replay the chunked prefill of prompt positions
      ``[0, length)`` into a private cache, scatter it into the page row
      rank 0 allocated (or the dense slot), point the slot at it, and
      arm the sampler state.
    - ``RELEASE``: park the slot's table on the null page.
    - ``PREFILL``: informational (the SP one-shot); the ADMIT replay
      writes the KV.
    - ``SHUTDOWN``: handled by `follower_serve`.
    """

    def __init__(self, cfg, model, *, max_len: int = 512,
                 slots: int = 4, prefill_chunk: int = 512,
                 kv_pages: Optional[int] = None, page_size: int = 16,
                 quantize_kv: bool = False, spec_tokens: int = 0,
                 max_top_k: int = 64, max_stop_ids: int = 16,
                 device: Union[str, torch.device] = 'cuda') -> None:
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f'model on {model.device}, follower on '
                             f'{self.device}')
        self.cfg = cfg
        self.model = model
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        self.max_top_k = int(max_top_k)
        self._sampler = sampler_lib.SlotSampler(int(max_top_k),
                                                int(max_stop_ids))
        self._paged = kv_pages is not None
        self._page_size = int(page_size)
        self._commands = 0
        if self._paged:
            self._cache = decode.init_paged_cache(
                cfg, int(kv_pages), self._page_size, int(slots),
                self.max_len // self._page_size,
                quantize_kv=bool(quantize_kv), device=self.device,
                model=model)
        else:
            if spec_tokens:
                raise ValueError('spec_tokens requires the paged KV '
                                 'engine (kv_pages)')
            self._cache = decode.init_slot_cache(cfg, int(slots),
                                                 self.max_len,
                                                 device=self.device,
                                                 model=model)
        self._state = decode.init_engine_state(int(slots),
                                               int(max_stop_ids),
                                               device=self.device)

    def _replay_prefill(self, prompt: List[int], length: int):
        """Chunked prefill of prompt positions [0, length): the engine's
        own chunk loop (chunk 0 flash, later chunks masked).  An MoE
        model replays rank 0's `_admit_moe`: the whole prompt unpadded,
        in one piece (chunk boundaries would change which tokens the
        capacity dispatch drops)."""
        if self.cfg.n_experts > 0:
            _, cache = decode.prefill(
                self.cfg, self.model,
                batching_engine_lib.tokens_tensor(prompt[:length], length,
                                                  self.device),
                max_len=self.max_len)
            return cache
        cache, consumed = None, 0
        while consumed < length:
            cache, consumed = batching_engine_lib.prefill_piece(
                self.cfg, self.model, prompt, cache, consumed, length,
                self.prefill_chunk, max_len=self.max_len,
                device=self.device, prefill=decode.prefill,
                prefill_chunk=decode.prefill_chunk)
        return cache

    def _admit(self, payload: Dict[str, Any]) -> None:
        slot = int(payload['slot'])
        length = int(payload['length'])
        row = payload.get('row')
        if length > 0:
            pre = self._replay_prefill(payload['prompt'], length)
            if self._paged:
                n_pages = -(-length // self._page_size)
                decode.insert_prefill_pages(self._cache, pre,
                                            row[:n_pages], first_page=0)
            else:
                decode.insert_prefill(self._cache, slot, pre, length)
        if self._paged:
            padded = list(row) + [0] * (self.max_len // self._page_size -
                                        len(row))
            decode.paged_admit_slot(self._cache, slot, padded, length)
        elif length == 0:
            self._cache['lengths'][slot] = 0
        self._state = self._sampler.admit(
            self._state, slot, int(payload['token']),
            int(payload['remaining']), frozenset(payload['stop_ids']),
            payload['key'], float(payload['temperature']),
            int(payload['top_k']))

    def __call__(self, cmd) -> None:
        payload = cmd.payload
        self._commands += 1
        if cmd.kind == coordinator_lib.CMD_TICK:
            drafts = payload.get('spec') if payload else None
            if drafts is not None:
                out = decode.paged_spec_engine_step(
                    self.cfg, self.model, self._state, self._cache,
                    torch.tensor(drafts, dtype=torch.int32,
                                 device=self.device),
                    max_top_k=self.max_top_k)
            elif self._paged:
                out = decode.paged_engine_step(
                    self.cfg, self.model, self._state, self._cache,
                    max_top_k=self.max_top_k)
            else:
                out = decode.engine_step(
                    self.cfg, self.model, self._state, self._cache,
                    max_top_k=self.max_top_k)
            self._state, self._cache = out[0], out[1]
        elif cmd.kind == coordinator_lib.CMD_ADMIT:
            self._admit(payload)
        elif cmd.kind == coordinator_lib.CMD_RELEASE and self._paged:
            decode.paged_release_slot(self._cache, int(payload['slot']))


def follower_main(rank: int, coordinator_address: str,
                  executor: Optional[FollowerExecutor] = None) -> None:
    """Rank > 0 of a slice: connect to rank 0's rank-protocol port and
    execute the command log (with an executor, on this rank's device;
    without one, the rank only holds the gang together)."""
    sock = coordinator_lib.follower_connect(coordinator_address, rank)
    logger.info('slice follower rank %d connected to %s', rank,
                coordinator_address)
    coordinator_lib.follower_serve(sock, rank, executor)


def _bench_prefill(args) -> None:
    """--bench-prefill: time ONE sequence-parallel prefill at a host
    count, its ranks emulated on one device (CUDA events on the card,
    the host clock on the CPU).  Prints the reference's JSON keys."""
    dev = resolve_device(args.device)
    cfg = configs.get_config(args.model)
    model = init_params(cfg, seed=0, device=dev)
    n = int(args.prompt_len)
    sequence = args.sequence
    if sequence is None and args.tensor is None:
        sequence = args.num_hosts
    mesh = build_slice_mesh(args.num_hosts, cfg, sequence=sequence,
                            tensor=args.tensor,
                            devices=[dev] * int(args.num_hosts))
    sp = int(mesh.shape['sequence'])
    if tensor_parallel.needs_ranks(mesh, dev, cfg):
        model = convert.to_tensor_parallel(cfg, model, mesh)
    width = -(-n // sp) * sp
    max_len = width + 16
    gen = torch.Generator().manual_seed(0)
    tokens = torch.zeros((1, width), dtype=torch.int32)
    tokens[0, :n] = torch.randint(1, cfg.vocab_size - 1, (n,),
                                  generator=gen, dtype=torch.int32)
    tokens = tokens.to(dev)

    def run():
        return decode.prefill_sp(cfg, model, tokens, mesh=mesh,
                                 max_len=max_len)

    run()                                   # warm-up
    times = []
    for _ in range(int(args.iters)):
        if dev.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    print(json.dumps({
        'num_hosts': int(args.num_hosts),
        'sequence': sp,
        'tensor': int(mesh.shape.get('tensor', 1)),
        'prompt_len': n,
        'prefill_s': sorted(times)[len(times) // 2],
        'prefill_s_all': [round(t, 6) for t in times],
    }))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--num-hosts', type=int,
                        default=int(os.environ.get(
                            'SKYTPU_NUM_HOSTS', '1')))
    parser.add_argument('--rank', type=int,
                        default=int(os.environ.get(
                            'SKYTPU_HOST_RANK', '0')))
    parser.add_argument('--coordinator',
                        default=os.environ.get(
                            'SKYTPU_COORDINATOR_ADDRESS'))
    parser.add_argument('--model', default='tiny')
    parser.add_argument('--max-len', type=int, default=512)
    parser.add_argument('--max-batch', type=int, default=8)
    parser.add_argument('--prefill-chunk', type=int, default=512)
    parser.add_argument('--bench-prefill', action='store_true')
    parser.add_argument('--prompt-len', type=int, default=2048)
    parser.add_argument('--sequence', type=int, default=None,
                        help='--bench-prefill: the sequence factor '
                             '(default: --num-hosts, or what --tensor '
                             'leaves).')
    parser.add_argument('--tensor', type=int, default=None,
                        help='The slice\'s tensor factor (default: '
                             '--bench-prefill 1; a follower rank the '
                             'largest the model allows, as rank 0 lays '
                             'it out by default).')
    parser.add_argument('--iters', type=int, default=3)
    parser.add_argument('--device', default='cuda')
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args, extra = build_parser().parse_known_args(argv)
    if args.bench_prefill:
        _bench_prefill(args)
        return
    if args.rank > 0:
        # A follower rank: the rank-protocol port is the gang
        # coordinator's + a fixed offset.  The executor mirrors rank 0's
        # geometry: model / max-len / max-batch / prefill-chunk from the
        # (gang-identical) CLI, the KV pool from the SKYTPU_SERVE_* env
        # every rank shares.
        if not args.coordinator:
            raise SystemExit('rank > 0 needs --coordinator (or the '
                             'gang env contract)')
        dev = resolve_device(args.device)
        cfg = configs.get_config(args.model)
        kv_pages_env = os.environ.get('SKYTPU_SERVE_KV_PAGES')
        # The slice's layout as rank 0 lays it out, its ranks emulated on
        # this rank's device: a tensor factor above 1 replays every
        # tensor rank.
        mesh = build_slice_mesh(args.num_hosts, cfg, sequence=args.sequence,
                                tensor=args.tensor,
                                devices=[dev] * args.num_hosts)
        model = (convert.init_tensor_parallel(cfg, mesh, seed=0)
                 if tensor_parallel.needs_ranks(mesh, dev, cfg)
                 else init_params(cfg, seed=0, device=dev))
        executor = FollowerExecutor(
            cfg, model,
            max_len=args.max_len, slots=args.max_batch,
            prefill_chunk=args.prefill_chunk,
            kv_pages=(int(kv_pages_env) if kv_pages_env else None),
            page_size=int(os.environ.get('SKYTPU_SERVE_PAGE_SIZE', '16')),
            quantize_kv=os.environ.get('SKYTPU_SERVE_KV_INT8', '') == '1',
            spec_tokens=int(os.environ.get('SKYTPU_SERVE_SPEC_TOKENS',
                                           '0')),
            device=dev)
        host, _, port = args.coordinator.rpartition(':')
        follower_main(args.rank,
                      f'{host}:{int(port) + SLICE_COORD_PORT_OFFSET}',
                      executor)
        return
    # Rank 0: the model server's CLI with num_hosts set, one entry
    # point for a slice's task.
    from skypilot_tpu_torch.serve import model_server  # pylint: disable=import-outside-toplevel
    pins = []
    for flag, value in (('--slice-sequence', args.sequence),
                        ('--slice-tensor', args.tensor)):
        if value is not None:
            pins += [flag, str(value)]
    model_server.main(pins + [
        '--num-hosts', str(args.num_hosts), '--model', args.model,
        '--max-len', str(args.max_len), '--max-batch', str(args.max_batch),
        '--prefill-chunk', str(args.prefill_chunk), '--device', args.device,
        '--continuous-batching'] + list(extra))


if __name__ == '__main__':
    main()
