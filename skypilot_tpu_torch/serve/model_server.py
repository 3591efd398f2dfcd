"""Model server of the port: `ModelServer` + a threaded HTTP front
(mirrors `skypilot_tpu/serve/model_server.py`: the routes below, with
the same JSON, status codes and error mapping).  `main` serves through
the asyncio front (serve/async_server.py, the same routes) unless
`--http-server threaded` is given.

    python -m skypilot_tpu_torch.serve.model_server --model llama3-8b \
        --continuous-batching [--kv-pages 1024] [--role decode] \
        [--http-server threaded]

- GET /health (and any other GET): {'status', 'model', 'role',
  'num_hosts', 'draining', 'device', 'weight_version', 'engine':
  stats}, plus 'slice' (the rank protocol's health) on a slice
  replica; 503 'engine_failed' once the engine failed (a dead rank
  fails a slice's engine).
- GET /metrics: the Prometheus exposition of the process-global
  registry (engine, scheduler, page pool, profiler, log and HTTP
  instruments; scrape-time gauges freshened through engine.stats()).
- GET /spans?since=&request_id=&limit=: {'segments': [...]}, the
  engine's finished request spans and the handoff routes' segments as
  identity-tagged trace segments, oldest first.
- GET /profile: the identity plus {'profile': engine.profile()} (the
  tick-phase ring and the shape sentinel's counts).
- GET /logs?since=&level=&request_id=&grep=&limit=: {'records': [...]},
  the structured log ring.
- Every response carries X-SkyTPU-Request-Id: the request's own, or a
  new id when it came without one; the id names the request's span and
  its access-log record.
- POST /generate {'prompt_ids': [[...], ...], 'max_new_tokens',
  'temperature', 'top_k', 'seed'} -> {'tokens', 'weight_version',
  'latency_ms'}.  400 for a malformed body, 429 + Retry-After when the
  admission queue or the page pool is full, 503 + Retry-After when the
  request expired queued, 504 past its deadline, 500 otherwise.  A
  client that hangs up mid-generation (a MSG_PEEK probe of its socket)
  cancels its requests; the engine frees their slots.
- Request headers: X-SkyTPU-QoS-Class (the class's token budget and
  deadline default, weighted admission order), X-SkyTPU-Deadline-Ms,
  and the LB's routing facts (X-SkyTPU-Routed-Role, -Affinity,
  -Handoff-Ms, -Attempt), stamped into the request's span and counted
  in skytpu_engine_routed_total.
- POST /drain -> {'draining': true, 'inflight'}: from then on
  /generate, /generate_stream, /generate_text, /prefill_export and
  /kv_import answer 503 + Retry-After while in-flight work finishes.
- POST /role_budget {'role', 'version', 'split' | 'prefill_tokens' and
  'decode_tokens', 'resume'} -> {'applied', 'morphed', 'role',
  'draining', 'budget'}: swaps the engine's per-tick budget in place; a
  push older than the budget in force is not applied; 400 without
  continuous batching or for an unknown role.
- POST /generate_stream (one prompt): SSE `data: {"token": N}` per
  token, then `data: [DONE]`; 400 without continuous batching.
- POST /generate_text {'prompt': str, 'max_new_tokens', 'stream'}:
  text through the byte tokenizer, {'completion', 'tokens', ...}, or
  with 'stream' SSE `data: {"text": delta}` (UTF-8-safe) then [DONE].
- POST /prefill_export {'prompt_ids', 'page_size', 'wire'}: the KV
  handoff's prefill side (serve/handoff.py JSON, or the binary frame
  for {'wire': 'binary'} or Accept: application/octet-stream).
- POST /kv_import (the JSON payload, or the frame as
  application/octet-stream) -> {'imported_pages', 'cached_pages'}; 429
  when the pool cannot hold the pages now, 400 on a mismatch.
- POST /prefix_export {'max_pages', 'wire'}: the hottest cached pages;
  404 when there are none.
- POST /weights_swap {'checkpoint_dir'} -> {'weight_version', 'step',
  'restore_ms'}: restores the newest step under `checkpoint_dir` onto
  the engine's device (re-quantized when this server quantizes) and
  swaps it in between ticks (`ContinuousBatchingEngine.swap_params`);
  400 "no checkpoint under ..." when there is none, 400 for a step not
  in the port's format (an orbax step) or of another shape.
  `weight_version` follows the engine's weight epoch.

Weights: the newest step of `checkpoint_dir` (the port's checkpoint,
data/checkpoints.py; `import_weights.convert` writes one from an HF
source, with model_config.json for `model='auto'` and the tokenizer
files), else seeded random values made on the device (`init_params`),
or a given Transformer (`params`, e.g. one model shared by two
servers).  `quantize='int8'` keeps every matmul kernel in int8 on the
device (models/quantize.py), quantized leaf by leaf as the weights
arrive.  `overrides` replaces fields of a preset (a depth cut of
`mixtral-8x7b`, say).  MoE presets (`mixtral-8x7b`, `tiny-moe`) and
converted Mixtral checkpoints serve in every mode: static, dense and
paged continuous batching, the legacy loop, both fronts.
`tensor` > 1 serves the model tensor-sharded
(models/tensor_parallel.py): per-rank weight shards, row-parallel
reductions, a vocab-parallel head and a KV pool per rank, over
`tensor_devices` when given (a list that may repeat one card), else
the first `tensor` visible cards (CPU entries with device='cpu').
`num_hosts` > 1 serves a slice (serve/slice_replica.py): `sequence x
tensor` by `slice_axes` (the reference's default: the largest tensor
factor the shapes allow; `slice_sequence` / `slice_tensor` pin it),
over `slice_devices` when given (a list that may repeat one card),
else the visible devices.  Weights of either restore straight to the
shards (`checkpoints.restore_params(pieces=)`).  An MoE config serves
at any tensor factor its shapes divide (the expert stacks cut on d_ff,
the routing replicated: models/tensor_parallel.py); int8 weights with a
tensor factor above 1 are refused.

Environment (as the reference's `main` and fronts read it):
SKYTPU_SERVE_KV_PAGES, _PAGE_SIZE, _KV_INT8=1, _SPEC_TOKENS,
_PREFIX_CACHE=0, SKYTPU_SERVE_REPLICA_NUM_HOSTS and
SKYTPU_SLICE_SP_THRESHOLD give `main`'s flag defaults (`build_parser`);
SKYTPU_SERVE_DEFAULT_DEADLINE_MS is the deadline of a request without
X-SkyTPU-Deadline-Ms (both fronts); SKYTPU_MODEL_FLOPS_PER_TOKEN
overrides the FLOPs estimate behind skytpu_engine_model_flops_per_token.

The flight recorder (observability/events.py): while someone watches,
the serving journal (`profiling.serve_journal`) gets a
`serve_request_done` per completed /generate, /generate_text and
/generate_stream (SKYTPU_SERVE_HANDOFF_EVENTS, or the
`serve.kv_handoff`, `serve.rank_exec` or `serve.controller_tick` chaos
site armed) and `weight_swap_start` / `_end` around /weights_swap
(SKYTPU_BATCH_EVENTS, or `batch.shard_write` armed); otherwise nothing
is written.  A recording error never reaches the request.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler
from http.server import ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from skypilot_tpu_torch.chaos import injector as chaos_injector
from skypilot_tpu_torch.device import device_scope
from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.data import checkpoints
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import import_weights
from skypilot_tpu_torch.models import quantize as quantize_lib
from skypilot_tpu_torch.models import tensor_parallel
from skypilot_tpu_torch.models import tokenizer as tokenizer_lib
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.observability import logs as logs_lib
from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import profiling
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import batching_engine as batching_engine_lib
from skypilot_tpu_torch.serve import handoff as handoff_lib
from skypilot_tpu_torch.serve import http_protocol
from skypilot_tpu_torch.serve import qos as qos_lib
from skypilot_tpu_torch.serve import roles as roles_lib

logger = logging.getLogger(__name__)

# Requests routed by role (the LB's X-SkyTPU-Routed-Role /
# X-SkyTPU-Affinity headers): the replica's view of the router.
_M_ROUTED = metrics_lib.counter(
    'skytpu_engine_routed_total',
    'LB-routed requests served, by routed role and affinity outcome.',
    ('role', 'affinity'))
_M_DRAIN_REJECTED = metrics_lib.counter(
    'skytpu_serve_drain_rejected_total',
    'Generation requests answered 503 because the replica is '
    'draining (the LB retries them on a sibling).')
# Live weight swap: the replica-side series the fleet aggregator folds
# into its batch section.
_M_WEIGHT_SWAPS = metrics_lib.counter(
    'skytpu_batch_weight_swaps_total',
    'Live weight swaps attempted on this replica (POST /weights_swap), '
    'by outcome.', ('status',))
_M_WEIGHT_EPOCH = metrics_lib.gauge(
    'skytpu_batch_weight_epoch',
    'Weight epoch currently serving (0 = boot weights; each '
    'successful live swap bumps it).')
_M_BATCH_ROWS = metrics_lib.counter(
    'skytpu_batch_rows_served_total',
    'Generation rows served under QoS class batch — the replica-side '
    'progress signal of a bulk-inference run.')

# Process identity marker: always 1; its labels (the registry's constant
# labels when SKYTPU_SERVE_REPLICA_ID is set) name this replica.
_M_PROCESS_INFO = metrics_lib.gauge(
    'skytpu_process_info',
    'Constant 1 carrying this process\'s identity labels '
    '(replica_id / role / num_hosts on serving replicas).')
# Forward FLOPs per generated token: the fleet aggregator multiplies
# it by decode tokens/s for the replica's MFU estimate.
_M_FLOPS_PER_TOKEN = metrics_lib.gauge(
    'skytpu_engine_model_flops_per_token',
    'Approximate forward FLOPs per generated token (2 x parameter '
    'count plus the context-dependent attention term) of the model '
    'this replica serves.')


class ClientDisconnected(RuntimeError):
    """The client hung up while its request was in flight: the engine
    slots were cancelled (the worker frees them); no response is owed."""


def _maybe_journal(watching: bool, event: str, **fields) -> None:
    if not watching:
        return
    try:
        profiling.serve_journal().append(event, **fields)
    except Exception:  # pylint: disable=broad-except
        pass  # recording must never break the serving path


def _maybe_journal_request(event: str, **fields) -> None:
    """Journal a request's completion only while someone watches
    (SKYTPU_SERVE_HANDOFF_EVENTS, or a handoff, rank or controller
    chaos site armed): the reference's `handoff_consistency` invariant
    replays these to show that no request is lost or run twice."""
    _maybe_journal(bool(os.environ.get('SKYTPU_SERVE_HANDOFF_EVENTS')) or
                   any(chaos_injector.site_armed(site) for site in (
                       'serve.kv_handoff', 'serve.rank_exec',
                       'serve.controller_tick')), event, **fields)


def _maybe_journal_batch(event: str, **fields) -> None:
    """Journal the weight-swap lifecycle only while someone watches
    (SKYTPU_BATCH_EVENTS, or the `batch.shard_write` chaos site
    armed)."""
    _maybe_journal(bool(os.environ.get('SKYTPU_BATCH_EVENTS')) or
                   chaos_injector.site_armed('batch.shard_write'),
                   event, **fields)


def parse_attempt(raw: Optional[str]) -> Optional[int]:
    """The LB's X-SkyTPU-Attempt value (None when absent or malformed;
    spans then read as attempt 0)."""
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def parse_route_meta(headers) -> Optional[Dict[str, Any]]:
    """Routing facts the LB forwarded (`headers.get` by header name);
    None for a direct hit.  Each routed request is counted here."""
    role = headers.get(http_protocol.ROUTED_ROLE_HEADER)
    affinity = headers.get(http_protocol.AFFINITY_HEADER)
    handoff_ms = headers.get(http_protocol.HANDOFF_MS_HEADER)
    if not (role or affinity or handoff_ms):
        return None
    _M_ROUTED.labels(role=role or 'unknown',
                     affinity=affinity or 'none').inc()
    try:
        ms = float(handoff_ms) if handoff_ms else None
    except ValueError:
        ms = None
    return {'routed_role': role,
            'affinity_hit': affinity == 'hit' if affinity else None,
            'handoff_ms': ms,
            'attempt': parse_attempt(
                headers.get(http_protocol.ATTEMPT_HEADER))}


def default_deadline_ms() -> Optional[float]:
    """The replica's default deadline (ms) for a request that carries
    no X-SkyTPU-Deadline-Ms: SKYTPU_SERVE_DEFAULT_DEADLINE_MS, None
    when unset, empty, malformed or not positive."""
    value = os.environ.get('SKYTPU_SERVE_DEFAULT_DEADLINE_MS')
    if not value:
        return None
    try:
        ms = float(value)
    except ValueError:
        return None
    return ms if ms > 0 else None


def parse_deadline_ms(headers) -> Optional[float]:
    """The request's X-SkyTPU-Deadline-Ms (None when it is not
    positive), else `default_deadline_ms()` when the header is absent
    or malformed, as both of the reference's fronts read it."""
    raw = headers.get(http_protocol.DEADLINE_HEADER)
    if raw:
        try:
            ms = float(raw)
            return ms if ms > 0 else None
        except ValueError:
            pass
    return default_deadline_ms()


def parse_qos_class(headers) -> str:
    """The request's X-SkyTPU-QoS-Class, clamped to a known class."""
    return qos_lib.normalize(headers.get(http_protocol.QOS_CLASS_HEADER))


def model_flops_per_token(cfg, n_params: int, max_len: int) -> float:
    """Forward FLOPs per generated token: ~2 x params for the matmuls,
    plus attention over the mean decode context (max_len / 2): QK^T and
    attn x V cost 2 x n_heads x head_dim each per layer and position.
    SKYTPU_MODEL_FLOPS_PER_TOKEN overrides the whole estimate (imported
    models whose tree misleads the count); a non-numeric value is
    logged and ignored."""
    override = os.environ.get('SKYTPU_MODEL_FLOPS_PER_TOKEN')
    if override:
        try:
            return float(override)
        except ValueError:
            logger.warning('Ignoring non-numeric '
                           'SKYTPU_MODEL_FLOPS_PER_TOKEN=%r', override)
    attn = (2.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim
            * float(max_len))
    return 2.0 * float(n_params) + attn


def n_leaf_elements(model) -> int:
    """Elements of every leaf of the model's reference tree: parameters
    and buffers (an int8 kernel's qvalue and scale), as the reference
    counts the leaves of its tree (a TensorParallel model's unsharded
    tree)."""
    if isinstance(model, tensor_parallel.TensorParallel):
        return model.n_elements()
    return (sum(p.numel() for p in model.parameters()) +
            sum(b.numel() for b in model.buffers()))


class ModelServer:

    def __init__(self, model: str, *, checkpoint_dir: Optional[str] = None,
                 max_len: int = 512,
                 max_batch: int = 8, seed: int = 0,
                 quantize: Optional[str] = None,
                 tokenizer_path: Optional[str] = None,
                 continuous_batching: bool = False,
                 max_queue: int = 0,
                 queue_ttl: Optional[float] = None,
                 prefill_chunk: int = 512,
                 default_temperature: float = 0.0,
                 default_top_k: int = 0,
                 default_seed: int = 0,
                 kv_pages: Optional[int] = None,
                 page_size: int = 16,
                 quantize_kv: bool = False,
                 prefix_caching: bool = True,
                 spec_tokens: int = 0,
                 role: str = roles_lib.DEFAULT_ROLE,
                 tensor: int = 1,
                 tensor_devices: Optional[List[Any]] = None,
                 num_hosts: int = 1,
                 sp_threshold: Optional[int] = None,
                 slice_sequence: Optional[int] = None,
                 slice_tensor: Optional[int] = None,
                 slice_devices: Optional[List[Any]] = None,
                 device: Union[str, torch.device] = 'cuda',
                 params=None,
                 overrides: Optional[Dict[str, Any]] = None) -> None:
        if quantize not in (None, 'int8'):
            # Before the (possibly minutes-long) restore, not after.
            raise ValueError(f'Unknown quantize mode {quantize!r}; '
                             "have 'int8'.")
        if tensor > 1 and quantize:
            raise ValueError(
                'quantize + tensor sharding is not supported yet '
                '(quantized leaves change the param pytree the '
                'shardings were computed for).')
        self.num_hosts = int(num_hosts)
        if self.num_hosts > 1:
            # The reference's refusals, in its order.
            if tensor > 1:
                raise ValueError(
                    '--num-hosts subsumes --tensor: the slice mesh '
                    'lays out sequence x tensor itself '
                    '(--slice-tensor pins the factor).')
            if quantize:
                raise ValueError(
                    'quantize + multi-host sharding is not supported '
                    'yet (quantized leaves change the param pytree '
                    'the shardings were computed for).')
            if not continuous_batching:
                raise ValueError('--num-hosts > 1 requires '
                                 '--continuous-batching (the slice '
                                 'engine IS the batching engine)')
        self.device = resolve_device(device)
        # The disaggregated-serving role this replica advertises
        # (/health); the engine is role-agnostic until a /role_budget
        # push gives it a budget.
        if role not in roles_lib.ROLES:
            raise ValueError(f'Unknown replica role {role!r}; one of '
                             f'{roles_lib.ROLES}')
        self.role = role
        # Set by POST /drain: new generation work is refused (503 +
        # Retry-After) while the engine finishes what it holds.
        self.draining = False
        if model == 'auto':
            # Converted checkpoints carry their own ModelConfig
            # (import_weights writes model_config.json next to step 0).
            cfg = (import_weights.load_model_config(checkpoint_dir)
                   if checkpoint_dir else None)
            if cfg is None:
                raise ValueError(
                    "--model auto needs --checkpoint-dir pointing at a "
                    "converted checkpoint (with model_config.json); see "
                    "python -m skypilot_tpu_torch.models.import_weights.")
            self.cfg = cfg
        else:
            # `overrides` replaces preset fields (a depth cut, say).
            self.cfg = configs.get_config(model, **(overrides or {}))
        self.model_name = model
        # A slice's mesh, or the tensor mesh; its first position is the
        # engine's device.
        mesh = None
        if self.num_hosts > 1:
            # A slice replica.  Imported here, as the reference does, so
            # a single-host replica registers no skytpu_slice_* families.
            from skypilot_tpu_torch.serve import slice_replica as slice_lib  # pylint: disable=import-outside-toplevel
            mesh = slice_lib.build_slice_mesh(
                self.num_hosts, self.cfg, devices=slice_devices,
                sequence=slice_sequence, tensor=slice_tensor,
                device=self.device)
        elif tensor > 1:
            if tensor_devices is not None:
                devices = list(tensor_devices)
            elif self.device.type == 'cuda':
                devices = mesh_lib.default_devices(self.device)
            else:
                devices = [self.device] * tensor
            if len(devices) < tensor:
                raise ValueError(f'tensor={tensor} needs {tensor} devices; '
                                 f'have {len(devices)}.')
            for dim in ('n_kv_heads', 'n_heads', 'd_ff', 'vocab_size'):
                value = getattr(self.cfg, dim)
                if value % tensor:
                    raise ValueError(
                        f'tensor={tensor} must divide {dim} ({value}) '
                        f'for {model!r}; pick a smaller degree.')
            mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(tensor=tensor),
                                       devices[:tensor])
        self._slice_mesh = mesh if self.num_hosts > 1 else None
        # The mesh the weights are sharded over: None when one plain
        # model on the first device serves it.
        self._mesh = None
        if mesh is not None:
            self.device = mesh.devices[0]
            if tensor_parallel.needs_ranks(mesh, self.device, self.cfg):
                self._mesh = mesh
        # The checkpoint's tokenizer when it ships one (converted
        # checkpoints do); the byte-level fallback otherwise.
        self.tokenizer = tokenizer_lib.load_tokenizer(
            tokenizer_path or checkpoint_dir)
        if self.tokenizer.eos_id is None:
            logger.warning(
                'Tokenizer has no EOS id (missing/incomplete '
                'tokenizer_config.json?): generation cannot stop '
                'early and will always run to max_new_tokens.')
        self.max_len = max_len
        self.max_batch = max_batch
        self.default_temperature = float(default_temperature)
        self.default_top_k = int(default_top_k)
        self.default_seed = int(default_seed)
        self._quantize = quantize
        if params is not None:
            if (params.cfg != self.cfg or params.device != self.device or
                    params.quantized != bool(quantize)):
                raise ValueError(
                    f'params are not a {model} model on {self.device}'
                    f'{" with int8 weights" if quantize else ""}')
            params = self._on_mesh(params)
        elif (checkpoint_dir and
              checkpoints.latest_step(checkpoint_dir) is not None):
            # Restored leaf by leaf onto the device, each cast (or
            # quantized) on arrival: no random weights are made just to
            # be overwritten.
            params = self._restore(checkpoint_dir)
        else:
            if checkpoint_dir:
                logger.warning('No checkpoint under %s; serving FRESH '
                               'random-init weights.', checkpoint_dir)
            else:
                logger.warning('No --checkpoint-dir given; serving FRESH '
                               'random-init weights.')
            # The single model's values (as the reference inits
            # unsharded, then places), cut onto the shards one leaf at a
            # time when the server has them.
            params = (convert.init_tensor_parallel(self.cfg, self._mesh,
                                                   seed=seed)
                      if self._mesh is not None else
                      init_params(self.cfg, seed=seed, device=self.device,
                                  quantize=quantize))
        if quantize:
            report = quantize_lib.quantization_report(
                convert.param_tree(params))
            logger.info('int8 weight-only quantization: %.1f MB (%.2fx of '
                        'f32)', report['quantized_bytes'] / 1e6,
                        report['ratio'])
        self.params = params
        # Process identity for fleet telemetry: the controller-set env
        # var names the replica; only then does this server own the
        # process-global registry's constant labels.
        env_rid = os.environ.get('SKYTPU_SERVE_REPLICA_ID')
        self.replica_id: Optional[int] = (
            int(env_rid) if env_rid and env_rid.isdigit() else None)
        if self.replica_id is not None:
            metrics_lib.REGISTRY.set_const_labels({
                'replica_id': env_rid, 'role': self.role,
                'num_hosts': self.num_hosts})
            logs_lib.set_process_identity(
                'replica', replica_id=self.replica_id, role=self.role)
        logs_lib.install()
        _M_PROCESS_INFO.set(1)
        # Trace segments of the non-engine legs of a request's life
        # (/prefill_export, /kv_import), exported with the engine's.
        self.trace_segments = tracing.SegmentStore()
        n_params = n_leaf_elements(params)
        self.flops_per_token = model_flops_per_token(self.cfg, n_params,
                                                     max_len)
        _M_FLOPS_PER_TOKEN.set(self.flops_per_token)
        self._lock = threading.Lock()
        self._engine: Optional[
            batching_engine_lib.ContinuousBatchingEngine] = None
        if continuous_batching:
            engine_kw = dict(
                max_len=max_len, slots=max_batch, max_queue=max_queue,
                queue_ttl=queue_ttl, prefill_chunk=prefill_chunk,
                kv_pages=kv_pages, page_size=page_size,
                quantize_kv=quantize_kv, prefix_caching=prefix_caching,
                spec_tokens=spec_tokens, device=self.device)
            if self.num_hosts > 1:
                # A slice replica: coordinated ticks across the gang and
                # sequence-parallel long-context prefill.  `slice_devices`
                # may repeat one card (emulated hosts).
                from skypilot_tpu_torch.serve import slice_replica as slice_lib  # pylint: disable=import-outside-toplevel
                self._engine = slice_lib.SliceReplicaEngine(
                    self.cfg, self.params, num_hosts=self.num_hosts,
                    sp_threshold=sp_threshold, mesh=self._slice_mesh,
                    **engine_kw)
            else:
                self._engine = batching_engine_lib.ContinuousBatchingEngine(
                    self.cfg, self.params, **engine_kw)
            self._engine.log_identity = {
                'process': 'replica', 'replica_id': self.replica_id,
                'role': self.role}

    @property
    def engine(self):
        return self._engine

    @property
    def weight_version(self) -> int:
        """The engine's weight epoch (0 without an engine)."""
        engine = self._engine
        return 0 if engine is None else engine.weight_epoch

    def _on_mesh(self, model):
        """`model` cut into this server's tensor shards (as it is when
        the server has none, or it holds them already)."""
        want = (None if self._mesh is None else
                tensor_parallel.mesh_layout(self._mesh))
        have = tensor_parallel.layout(model)
        if have is None and want is not None:
            return convert.to_tensor_parallel(self.cfg, model, self._mesh)
        if have != want:
            raise ValueError(f'params are sharded as {have}, this server '
                             f'as {want}')
        return model

    def _restore(self, checkpoint_dir: str, step: Optional[int] = None):
        """The step's weights as a serving Transformer on this server's
        device, int8 when it quantizes; with tensor shards, each rank's
        slice of each leaf read from the file onto its device."""
        leaf_fn = convert.serving_leaf(self.cfg, bool(self._quantize))
        if self._mesh is not None:
            trees = checkpoints.restore_params(
                checkpoint_dir, device=self.device, step=step,
                leaf_fn=leaf_fn, pieces=convert.tensor_pieces(self._mesh))
            return convert.from_rank_trees(self.cfg, trees, self._mesh)
        tree = checkpoints.restore_params(
            checkpoint_dir, device=self.device, step=step, leaf_fn=leaf_fn)
        return convert.from_jax_params(self.cfg, tree, device=self.device)

    def weights_swap(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """POST /weights_swap: restore the newest step under
        `checkpoint_dir` (re-quantized when this server quantizes) and
        swap it into the running engine between ticks, keeping the KV
        pool and every in-flight request (swap_params).  The bumped
        weight epoch lands in /health, later spans and responses."""
        engine = self._engine
        if engine is None:
            raise ValueError('live weight swap requires '
                             '--continuous-batching')
        checkpoint_dir = req.get('checkpoint_dir')
        if not checkpoint_dir or not isinstance(checkpoint_dir, str):
            raise ValueError('weights_swap needs a checkpoint_dir')
        step = checkpoints.latest_step(checkpoint_dir)
        if step is None:
            raise ValueError(f'no checkpoint under {checkpoint_dir}')
        _maybe_journal_batch('weight_swap_start',
                             replica_id=self.replica_id,
                             checkpoint_dir=checkpoint_dir, step=step)
        t0 = time.perf_counter()
        status = 'error'
        epoch: Optional[int] = None
        try:
            with device_scope(self.device):
                model = self._restore(checkpoint_dir, step)
            epoch = engine.swap_params(model)
            self.params = model
            status = 'ok'
        finally:
            _M_WEIGHT_SWAPS.labels(status=status).inc()
            if epoch is not None:
                _M_WEIGHT_EPOCH.set(epoch)
            _maybe_journal_batch('weight_swap_end',
                                 replica_id=self.replica_id,
                                 status=status, weight_epoch=epoch)
        return {'weight_version': epoch, 'step': step,
                'restore_ms': round((time.perf_counter() - t0) * 1e3, 1)}

    def close(self) -> None:
        """Stop the batching engine's worker; safe to call twice."""
        if self._engine is not None:
            self._engine.stop()
            self._engine = None

    def drain(self) -> Dict[str, Any]:
        """POST /drain: refuse new generation work (503 + Retry-After)
        while the engine finishes what it holds.  Idempotent; returns the
        in-flight count the controller's drain waits on."""
        self.draining = True
        return {'draining': True, 'inflight': self.inflight()}

    def inflight(self) -> int:
        """Busy slots + queued requests (0 without an engine)."""
        engine = self._engine
        if engine is None:
            return 0
        stats = engine.stats()
        return (int(stats.get('busy_slots', 0)) +
                int(stats.get('queued_requests', 0)))

    def apply_role_budget(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """POST /role_budget: a rebalance push or a role-morph commit.
        Swaps the engine's budget in place: explicit prefill/decode
        tokens, else a `split`, else the role's launch profile.  When it
        names another role and is applied, the advertised role flips and
        draining clears (the morph's drain is over); `resume` re-opens a
        draining replica under its role.  A push older than the budget
        in force is dropped."""
        engine = self._engine
        if engine is None:
            raise ValueError('role budgets require --continuous-batching')
        new_role = roles_lib.normalize(req.get('role') or self.role)
        version = int(req.get('version', 0))
        split = req.get('split')
        if (req.get('prefill_tokens') is not None and
                req.get('decode_tokens') is not None):
            budget = batching_engine_lib.RoleBudget(
                prefill_tokens=int(req['prefill_tokens']),
                decode_tokens=int(req['decode_tokens']),
                role=new_role,
                split=float(split) if split is not None
                else roles_lib.DEFAULT_SPLITS[new_role],
                version=version)
        elif split is not None:
            budget = batching_engine_lib.RoleBudget.from_split(
                float(split), slots=self.max_batch,
                prefill_chunk=engine.prefill_chunk, role=new_role,
                version=version)
        else:
            budget = batching_engine_lib.RoleBudget.for_role(
                new_role, slots=self.max_batch,
                prefill_chunk=engine.prefill_chunk, version=version)
        applied = engine.set_role_budget(budget)
        morphed = applied and new_role != self.role
        if morphed:
            self.role = new_role
            self.draining = False
        elif applied and req.get('resume'):
            self.draining = False
        return {'applied': applied, 'morphed': morphed,
                'role': self.role, 'draining': self.draining,
                'budget': budget.as_dict()}

    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int = 0,
                 stop_token=None, seed: int = 0,
                 request_id: Optional[str] = None,
                 route_meta: Optional[Dict[str, Any]] = None,
                 deadline_ms: Optional[float] = None,
                 qos_class: Optional[str] = None,
                 on_submit=None, disconnect_probe=None) -> List[List[int]]:
        """prompt_ids [batch][seq] -> new tokens per row.  Under
        continuous batching each row is its own engine request (rows
        after the first get `request_id` suffixed -1, -2, ...).

        on_submit: called with the engine requests right after they are
        submitted (the async front's disconnect watchdog cancels through
        them).  disconnect_probe: polled while waiting; True means the
        client hung up: every request is cancelled and ClientDisconnected
        raised (the threaded front's MSG_PEEK probe).  Without an engine
        the lock-step decode runs in the calling thread, on this
        server's device."""
        if (not isinstance(prompt_ids, list) or not prompt_ids or
                not all(isinstance(r, list) and r for r in prompt_ids)):
            raise ValueError('prompt_ids must be [batch, seq]')
        if len({len(r) for r in prompt_ids}) != 1:
            raise ValueError('prompt_ids rows must have equal length')
        rows = [[int(t) for t in r] for r in prompt_ids]
        if len(rows) > self.max_batch:
            raise ValueError(f'batch {len(rows)} > max_batch '
                             f'{self.max_batch}')
        if len(rows[0]) + max_new_tokens > self.max_len:
            raise ValueError(f'prompt {len(rows[0])} + new '
                             f'{max_new_tokens} exceeds max_len '
                             f'{self.max_len}')
        sampling = decode.SamplingConfig(temperature=temperature,
                                         top_k=top_k, seed=seed)
        engine = self._engine
        if engine is not None:
            requests = [
                engine.submit(row, max_new_tokens, stop_token=stop_token,
                              sampling=sampling,
                              request_id=(None if request_id is None else
                                          request_id if i == 0 else
                                          f'{request_id}-{i}'),
                              route_meta=route_meta,
                              deadline_ms=deadline_ms, qos_class=qos_class)
                for i, row in enumerate(rows)]
            if on_submit is not None:
                on_submit(requests)
            if disconnect_probe is not None:
                wait_until = time.monotonic() + 600
                while True:
                    pending = next((r for r in requests
                                    if not r.done.is_set()), None)
                    if pending is None:
                        break
                    if disconnect_probe():
                        for r in requests:
                            r.cancel()
                        raise ClientDisconnected(
                            'client disconnected mid-generation')
                    if time.monotonic() > wait_until:
                        raise TimeoutError('generation timed out')
                    pending.done.wait(0.1)
            return [list(r.result(timeout=600)) for r in requests]
        vocab = self.cfg.vocab_size
        if any(not 0 <= t < vocab for row in rows for t in row):
            raise ValueError(f'prompt ids must lie in [0, {vocab})')
        with self._lock, device_scope(self.device):
            prompt = torch.tensor(rows, dtype=torch.int64,
                                  device=self.device)
            _, new = decode.generate(self.cfg, self.params, prompt,
                                     max_new_tokens=max_new_tokens,
                                     max_len=self.max_len,
                                     sampling=sampling)
        return new.tolist()

    def identity(self) -> Dict[str, Any]:
        """Trace-segment identity tags for this replica's exports."""
        return {'process': 'replica', 'replica_id': self.replica_id,
                'role': self.role, 'num_hosts': self.num_hosts}

    def export_spans(self, since: Optional[float] = None,
                     request_id: Optional[str] = None,
                     limit: Optional[int] = None) -> Dict[str, Any]:
        """The `GET /spans` payload: engine request spans + the
        handoff routes' segments, identity-tagged, oldest first."""
        segments = self.trace_segments.export(
            since=since, request_id=request_id)
        engine = self._engine
        if engine is not None:
            segments.extend(engine._spans.export(  # pylint: disable=protected-access
                self.identity(), since=since, request_id=request_id))
        segments.sort(key=lambda s: s.get('start') or 0.0)
        if limit is not None:
            segments = segments[-int(limit):]
        return {'segments': segments}

    def export_profile(self) -> Dict[str, Any]:
        """The `GET /profile` payload: the engine's tick-phase ring and
        sentinel snapshot, identity-tagged."""
        payload = self.identity()
        engine = self._engine
        payload['profile'] = (engine.profile() if engine is not None
                              else None)
        return payload

    def record_handoff_segment(self, name: str, request_id: str,
                               start: float, duration_ms: float,
                               attempt: Optional[int] = None,
                               **fields: Any) -> None:
        """One non-engine leg of a request's life (/prefill_export,
        /kv_import) as a trace segment: an export never creates an
        engine span."""
        seg = self.identity()
        seg.update({'name': name, 'request_id': request_id,
                    'start': start,
                    'duration_ms': round(duration_ms, 3),
                    'attempt': int(attempt or 0), 'phases': []})
        seg.update(fields)
        self.trace_segments.add(seg)

    def health(self) -> Tuple[int, Dict[str, Any]]:
        """(HTTP code, the health payload): 503 once the engine failed."""
        payload = {'status': 'ok',
                   'model': f'{self.cfg.d_model}x{self.cfg.n_layers}',
                   'role': self.role, 'num_hosts': self.num_hosts,
                   'draining': self.draining,
                   'device': str(self.device),
                   'weight_version': self.weight_version}
        engine = self._engine
        if engine is not None:
            stats = engine.stats()
            payload['engine'] = stats
            if 'slice' in stats:
                # Gang health top-level: the controller's probe tells a
                # dead rank (tear down, replace) from a transient flap.
                payload['slice'] = stats['slice']
            if stats['failed']:
                payload['status'] = 'engine_failed'
        return 200 if payload['status'] == 'ok' else 503, payload


def _make_handler(server: ModelServer):

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def log_message(self, *args):
            del args

        def send_response(self, code, message=None):
            # Every response echoes the request id; the status is kept
            # for the access log (the last one sent is what went out).
            self._status = code
            super().send_response(code, message)
            rid = getattr(self, '_rid', None)   # None before _begin
            if rid:
                self.send_header(http_protocol.REQUEST_ID_HEADER, rid)

        def _begin(self) -> str:
            """The matched route (the access log's label), with the
            request id read from X-SkyTPU-Request-Id or made anew."""
            self._status = 0
            self._rid = (self.headers.get(http_protocol.REQUEST_ID_HEADER)
                         or tracing.new_request_id())
            path = self.path.partition('?')[0]
            return (path if path in http_protocol.REPLICA_PATHS
                    else None)

        def _read_body(self) -> bytes:
            length = int(self.headers.get('Content-Length', 0))
            return self.rfile.read(length)

        def _reply(self, code: int, payload: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_backpressure(self, e: Exception) -> bool:
            """429 when the queue/pool is full, 503 when the request
            expired queued, 504 past its deadline."""
            if isinstance(e, batching_engine_lib.QueueFull):
                self._reply(429, {'error': str(e)},
                            {'Retry-After': str(int(e.retry_after))})
                return True
            if isinstance(e, batching_engine_lib.QueueExpired):
                self._reply(503, {'error': str(e)},
                            {'Retry-After': str(int(e.retry_after))})
                return True
            if isinstance(e, batching_engine_lib.DeadlineExceeded):
                self._reply(504, {'error': str(e),
                                  'reason': 'deadline_exceeded'})
                return True
            return False

        def _reject_if_draining(self) -> bool:
            """503 + Retry-After for new generation work on a draining
            replica (the LB's same-role retry lands it on a sibling).
            The body is read first: unread bytes would break the framing
            of a keep-alive connection's next request."""
            if not server.draining:
                return False
            self._read_body()
            _M_DRAIN_REJECTED.inc()
            self._reply(503, {'error': 'replica is draining',
                              'reason': 'draining'},
                        {'Retry-After': '5'})
            return True

        def _disconnect_probe(self):
            """True once the client's socket is closed.  MSG_PEEK never
            consumes pipelined bytes: data waiting reads as connected,
            only an EOF (or a dead socket) as gone."""
            sock = self.connection

            def probe() -> bool:
                try:
                    readable, _, _ = select.select([sock], [], [], 0)
                    if not readable:
                        return False
                    return sock.recv(1, socket.MSG_PEEK) == b''
                except (OSError, ValueError):
                    return True
            return probe

        def _bind(self):
            """The request-scoped log context (id, attempt, identity)."""
            return logs_lib.bind(
                request_id=self._rid,
                attempt=parse_attempt(
                    self.headers.get(http_protocol.ATTEMPT_HEADER)),
                process='replica', replica_id=server.replica_id,
                role=server.role)

        def do_GET(self):
            route = self._begin() or logs_lib.HEALTH_ROUTE
            with self._bind():
                try:
                    self._get(route, self.path.partition('?')[2])
                finally:
                    logs_lib.access_log(logger, 'GET', route,
                                        self._status)

        def _get(self, route: str, query: str) -> None:
            if route == http_protocol.METRICS:
                engine = server.engine
                if engine is not None:
                    engine.stats()   # freshen the scrape-time gauges
                body = metrics_lib.expose().encode()
                self.send_response(200)
                self.send_header('Content-Type', metrics_lib.CONTENT_TYPE)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif route == http_protocol.SPANS:
                self._reply(200, server.export_spans(
                    **tracing.parse_span_query(query)))
            elif route == http_protocol.PROFILE:
                self._reply(200, server.export_profile())
            elif route == http_protocol.LOGS:
                self._reply(200, {'records': logs_lib.get_ring().export(
                    **logs_lib.parse_log_query(query))})
            else:
                self._reply(*server.health())

        def _read_json(self) -> Dict[str, Any]:
            req = json.loads(self._read_body() or b'{}')
            if not isinstance(req, dict):
                raise ValueError('body must be a JSON object')
            return req

        def _sampling(self, req: Dict[str, Any]):
            """(temperature, top_k, seed): the request's, else the
            server's defaults."""
            return (float(req.get('temperature',
                                  server.default_temperature)),
                    int(req.get('top_k', server.default_top_k)),
                    int(req.get('seed', server.default_seed)))

        def _reply_bytes(self, payload: bytes) -> None:
            self.send_response(200)
            self.send_header('Content-Type',
                             handoff_lib.CONTENT_TYPE_BINARY)
            self.send_header('Content-Length', str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _wants_binary(self, req: Dict[str, Any]) -> bool:
            return (req.get('wire') == 'binary' or
                    handoff_lib.CONTENT_TYPE_BINARY in
                    (self.headers.get('Accept') or ''))

        def _start_sse(self) -> None:
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('Cache-Control', 'no-cache')
            self.send_header('Transfer-Encoding', 'chunked')
            self.end_headers()

        def _sse_chunk(self, data: str) -> None:
            payload = f'data: {data}\n\n'.encode()
            self.wfile.write(f'{len(payload):x}\r\n'.encode() + payload +
                             b'\r\n')
            self.wfile.flush()

        def _sse_stream(self, request, events) -> bool:
            """Answer with the SSE frames `events` yields from the
            request's token stream, then [DONE]; a client that goes
            away, or any other failure, cancels the request.  -> whether
            the stream reached [DONE]."""
            self._start_sse()
            try:
                for data in events:
                    self._sse_chunk(data)
                self._sse_chunk('[DONE]')
                self.wfile.write(b'0\r\n\r\n')
                return True
            except (BrokenPipeError, ConnectionResetError):
                request.cancel()
            except Exception as e:  # pylint: disable=broad-except
                request.cancel()
                try:
                    self._sse_chunk(json.dumps(
                        {'error': f'{type(e).__name__}: {e}'}))
                    self.wfile.write(b'0\r\n\r\n')
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
            return False

        def _generate(self):
            if self._reject_if_draining():
                return
            try:
                req = self._read_json()
                t0 = time.perf_counter()
                temperature, top_k, seed = self._sampling(req)
                qos = parse_qos_class(self.headers)
                tokens = server.generate(
                    req['prompt_ids'], int(req.get('max_new_tokens', 16)),
                    temperature, top_k, seed=seed, request_id=self._rid,
                    route_meta=parse_route_meta(self.headers),
                    deadline_ms=parse_deadline_ms(self.headers),
                    qos_class=qos,
                    disconnect_probe=self._disconnect_probe())
                if qos == qos_lib.BATCH:
                    _M_BATCH_ROWS.inc(len(tokens))
                _maybe_journal_request(
                    'serve_request_done', request_id=self._rid,
                    status='ok', tokens=sum(len(t) for t in tokens))
                self._reply(200, {
                    'tokens': tokens,
                    'weight_version': server.weight_version,
                    'latency_ms': round(
                        (time.perf_counter() - t0) * 1e3, 1),
                })
            except ClientDisconnected:
                return   # nobody is owed a reply; the slots are freed
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {'error': str(e)})
            except Exception as e:  # pylint: disable=broad-except
                # Engine failures must reach the client as an HTTP error
                # (admission pushback as 429/503/504), not a dropped
                # connection.
                if not self._reply_backpressure(e):
                    self._reply(500, {'error': f'{type(e).__name__}: {e}'})

        def _generate_stream(self):
            """SSE token stream of one prompt (continuous batching)."""
            if self._reject_if_draining():
                return
            try:
                req = self._read_json()
                prompt = req['prompt_ids']
                if (isinstance(prompt, list) and prompt and
                        isinstance(prompt[0], list)):
                    if len(prompt) != 1:
                        raise ValueError(
                            'streaming serves one prompt per request')
                    prompt = prompt[0]
                if server.engine is None:
                    self._reply(400, {'error': 'streaming requires '
                                               '--continuous-batching'})
                    return
                temperature, top_k, seed = self._sampling(req)
                request = server.engine.submit(
                    [int(t) for t in prompt],
                    int(req.get('max_new_tokens', 16)),
                    stop_token=req.get('stop_token'),
                    sampling=decode.SamplingConfig(
                        temperature=temperature, top_k=top_k, seed=seed),
                    request_id=self._rid,
                    route_meta=parse_route_meta(self.headers),
                    deadline_ms=parse_deadline_ms(self.headers),
                    qos_class=parse_qos_class(self.headers))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {'error': str(e)})
                return
            except Exception as e:  # pylint: disable=broad-except
                # A stopped or failed engine (503) or a full queue (429).
                if not self._reply_backpressure(e):
                    self._reply(503, {'error': f'{type(e).__name__}: {e}'})
                return
            if self._sse_stream(request, (
                    json.dumps({'token': token})
                    for token in request.stream(timeout=600))):
                _maybe_journal_request('serve_request_done',
                                       request_id=self._rid, status='ok',
                                       tokens=len(request.tokens))

        def _generate_text(self):
            """Text in, text out through the server's tokenizer; with
            {"stream": true} SSE {"text": delta} events."""
            if self._reject_if_draining():
                return
            try:
                tok = server.tokenizer
                if server.cfg.vocab_size < tok.vocab_size:
                    raise ValueError(
                        f'model vocab {server.cfg.vocab_size} < '
                        f'tokenizer vocab {tok.vocab_size}: checkpoint '
                        'and tokenizer do not match')
                req = self._read_json()
                text = req['prompt']
                if not isinstance(text, str) or not text:
                    raise ValueError('prompt must be a non-empty string')
                ids = tok.encode(text, add_bos=True)
                if not ids:
                    raise ValueError('prompt tokenized to nothing')
                temperature, top_k, seed = self._sampling(req)
                max_new = int(req.get('max_new_tokens', 64))
                if req.get('stream'):
                    if server.engine is None:
                        self._reply(400, {'error': 'streaming requires '
                                                   '--continuous-batching'})
                        return
                    request = server.engine.submit(
                        ids, max_new, stop_token=tok.eos_ids or None,
                        sampling=decode.SamplingConfig(
                            temperature=temperature, top_k=top_k,
                            seed=seed),
                        request_id=self._rid,
                        route_meta=parse_route_meta(self.headers),
                        deadline_ms=parse_deadline_ms(self.headers),
                        qos_class=parse_qos_class(self.headers))
                    self._sse_stream(request,
                                     self._text_events(tok, request))
                    return
                t0 = time.perf_counter()
                tokens = server.generate(
                    [ids], max_new, temperature, top_k,
                    stop_token=tok.eos_ids or None, seed=seed,
                    request_id=self._rid,
                    route_meta=parse_route_meta(self.headers),
                    deadline_ms=parse_deadline_ms(self.headers),
                    qos_class=parse_qos_class(self.headers),
                    disconnect_probe=self._disconnect_probe())[0]
                _maybe_journal_request('serve_request_done',
                                       request_id=self._rid, status='ok',
                                       tokens=len(tokens))
                stops = [i for i, t in enumerate(tokens)
                         if t in tok.eos_ids]
                if stops:
                    tokens = tokens[:stops[0]]
                self._reply(200, {
                    'completion': tok.decode(tokens),
                    'tokens': tokens,
                    'weight_version': server.weight_version,
                    'latency_ms': round(
                        (time.perf_counter() - t0) * 1e3, 1),
                })
            except ClientDisconnected:
                return
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {'error': str(e)})
            except Exception as e:  # pylint: disable=broad-except
                if not self._reply_backpressure(e):
                    self._reply(500, {'error': f'{type(e).__name__}: {e}'})

        @staticmethod
        def _text_events(tok, request):
            """{"text": delta} per token up to the tokenizer's EOS,
            skipping tokens inside a multi-byte sequence."""
            decoder = tokenizer_lib.StreamDecoder(tok)
            for token in request.stream(timeout=600):
                if token in tok.eos_ids:
                    break
                delta = decoder.push(token)
                if delta:
                    yield json.dumps({'text': delta})
            tail = decoder.finish()
            if tail:
                yield json.dumps({'text': tail})

        def _prefill_export(self):
            """KV handoff, prefill side: the prompt's full pages as a
            wire payload (JSON, or the binary frame on request)."""
            if server.engine is None:
                self._reply(400, {'error': 'KV handoff requires '
                                           '--continuous-batching'})
                return
            if self._reject_if_draining():
                return
            try:
                req = self._read_json()
                prompt = req['prompt_ids']
                if (isinstance(prompt, list) and prompt and
                        isinstance(prompt[0], list)):
                    if len(prompt) != 1:
                        raise ValueError(
                            'export serves one prompt per request')
                    prompt = prompt[0]
                binary = self._wants_binary(req)
                t0, wall0 = time.perf_counter(), time.time()
                payload = server.engine.export_prefill(
                    [int(t) for t in prompt],
                    page_size=req.get('page_size'), binary=binary)
                server.record_handoff_segment(
                    'prefill_export', self._rid, wall0,
                    (time.perf_counter() - t0) * 1e3,
                    attempt=parse_attempt(
                        self.headers.get(http_protocol.ATTEMPT_HEADER)),
                    tokens=len(prompt))
                if binary:
                    self._reply_bytes(payload)
                else:
                    self._reply(200, payload)
            except (handoff_lib.HandoffError, KeyError, ValueError,
                    TypeError, json.JSONDecodeError) as e:
                self._reply(400, {'error': str(e)})
            except Exception as e:  # pylint: disable=broad-except
                if not self._reply_backpressure(e):
                    self._reply(500, {'error': f'{type(e).__name__}: {e}'})

        def _kv_import(self):
            """KV handoff, decode side: adopt exported pages into the
            pool and the prefix cache (JSON or the binary frame)."""
            if server.engine is None:
                self._reply(400, {'error': 'KV handoff requires '
                                           '--continuous-batching'})
                return
            if self._reject_if_draining():
                return   # imported pages would die with this replica
            try:
                ctype = self.headers.get('Content-Type') or ''
                if handoff_lib.CONTENT_TYPE_BINARY in ctype:
                    decoded = handoff_lib.decode_binary(self._read_body())
                else:
                    decoded = handoff_lib.decode_payload(self._read_json())
                t0, wall0 = time.perf_counter(), time.time()
                imported, cached = server.engine.import_pages(
                    decoded['hashes'], decoded['page_size'],
                    decoded['k'], decoded['v'],
                    k_scale=decoded.get('k_scale'),
                    v_scale=decoded.get('v_scale'))
                server.record_handoff_segment(
                    'kv_import', self._rid, wall0,
                    (time.perf_counter() - t0) * 1e3,
                    attempt=parse_attempt(
                        self.headers.get(http_protocol.ATTEMPT_HEADER)),
                    imported_pages=imported, cached_pages=cached)
                self._reply(200, {'imported_pages': imported,
                                  'cached_pages': cached})
            except handoff_lib.HandoffRejected as e:
                self._reply(503, {'error': str(e),
                                  'reason': 'kv_handoff_denied'})
            except (handoff_lib.HandoffError, KeyError, ValueError,
                    TypeError, json.JSONDecodeError) as e:
                self._reply(400, {'error': str(e)})
            except Exception as e:  # pylint: disable=broad-except
                if not self._reply_backpressure(e):
                    self._reply(500, {'error': f'{type(e).__name__}: {e}'})

        def _prefix_export(self):
            """Drain-time sibling handoff: the hottest prefix-cache
            pages (no prefill runs)."""
            if server.engine is None:
                self._reply(400, {'error': 'prefix export requires '
                                           '--continuous-batching'})
                return
            try:
                req = self._read_json()
                binary = self._wants_binary(req)
                payload = server.engine.export_prefix_pages(
                    max_pages=int(req.get('max_pages', 64)),
                    binary=binary)
                if binary:
                    self._reply_bytes(payload)
                else:
                    self._reply(200, payload)
            except (handoff_lib.HandoffError, KeyError, ValueError,
                    TypeError, json.JSONDecodeError) as e:
                self._reply(404, {'error': str(e)})
            except Exception as e:  # pylint: disable=broad-except
                if not self._reply_backpressure(e):
                    self._reply(500, {'error': f'{type(e).__name__}: {e}'})

        def _drain(self):
            """Controller retirement: refuse new generation work from
            now on and report the in-flight count."""
            self._read_body()
            self._reply(200, server.drain())

        def _role_budget(self):
            """Rebalance push / morph commit (allowed while draining: a
            morph drains, then commits)."""
            try:
                self._reply(200,
                            server.apply_role_budget(self._read_json()))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {'error': str(e)})
            except Exception as e:  # pylint: disable=broad-except
                self._reply(500, {'error': f'{type(e).__name__}: {e}'})

        def _weights_swap(self):
            try:
                self._reply(200, server.weights_swap(self._read_json()))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {'error': str(e)})
            except Exception as e:  # pylint: disable=broad-except
                self._reply(500, {'error': f'{type(e).__name__}: {e}'})

        def do_POST(self):
            route = self._begin()
            handler = {
                http_protocol.GENERATE: self._generate,
                http_protocol.GENERATE_STREAM: self._generate_stream,
                http_protocol.GENERATE_TEXT: self._generate_text,
                http_protocol.PREFILL_EXPORT: self._prefill_export,
                http_protocol.KV_IMPORT: self._kv_import,
                http_protocol.PREFIX_EXPORT: self._prefix_export,
                http_protocol.DRAIN: self._drain,
                http_protocol.ROLE_BUDGET: self._role_budget,
                http_protocol.WEIGHTS_SWAP: self._weights_swap,
            }.get(route)
            with self._bind():
                try:
                    if handler is None:
                        self._read_body()
                        self._reply(404, {'error': 'unknown path'})
                    else:
                        handler()
                finally:
                    logs_lib.access_log(logger, 'POST', route or 'unknown',
                                        self._status)

    return Handler


def serve_forever(server: ModelServer, port: int = 0,
                  host: str = '0.0.0.0') -> None:
    httpd = ThreadingHTTPServer((host, port), _make_handler(server))
    logger.info('model server on :%d', httpd.server_port)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()


def start_background(server: ModelServer, port: int = 0,
                     host: str = '127.0.0.1'):
    """Start the HTTP front on a daemon thread; returns (port, stop)."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def stop() -> None:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)

    return httpd.server_port, stop


def build_parser() -> argparse.ArgumentParser:
    """`main`'s flags.  --kv-pages, --page-size, --quantize-kv,
    --spec-tokens, --no-prefix-cache, --num-hosts and --sp-threshold
    take their defaults from the environment as the reference's `main`
    reads it (SKYTPU_SERVE_KV_PAGES, _PAGE_SIZE, _KV_INT8=1,
    _SPEC_TOKENS, _PREFIX_CACHE=0, SKYTPU_SERVE_REPLICA_NUM_HOSTS,
    SKYTPU_SLICE_SP_THRESHOLD), read when the parser is built."""
    env = os.environ
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny',
                        help=f'Preset name: {sorted(configs.PRESETS)}, or '
                             "'auto' to read model_config.json from "
                             '--checkpoint-dir.')
    parser.add_argument('--port', type=int, default=8080)
    parser.add_argument('--max-len', type=int, default=512)
    parser.add_argument('--max-batch', type=int, default=8)
    parser.add_argument('--continuous-batching', action='store_true',
                        help='Slot-pool scheduling with pipelined ticks '
                             '(a dense slot cache unless --kv-pages).')
    parser.add_argument('--kv-pages', type=int,
                        default=(int(env['SKYTPU_SERVE_KV_PAGES'])
                                 if env.get('SKYTPU_SERVE_KV_PAGES')
                                 else None),
                        help='Paged KV cache: a pool of N pages (env '
                             'SKYTPU_SERVE_KV_PAGES).')
    parser.add_argument('--page-size', type=int,
                        default=int(env.get('SKYTPU_SERVE_PAGE_SIZE',
                                            '16')),
                        help='Tokens per KV page (env '
                             'SKYTPU_SERVE_PAGE_SIZE).')
    parser.add_argument('--quantize-kv', action='store_true',
                        default=env.get('SKYTPU_SERVE_KV_INT8', '') == '1',
                        help='int8 KV pages with per-token scales (env '
                             'SKYTPU_SERVE_KV_INT8=1).')
    parser.add_argument('--spec-tokens', type=int,
                        default=int(env.get('SKYTPU_SERVE_SPEC_TOKENS',
                                            '0')),
                        help='Self-speculative decoding: N n-gram drafts '
                             'per slot verified in one tick (0 = off; env '
                             'SKYTPU_SERVE_SPEC_TOKENS).')
    parser.add_argument('--no-prefix-cache', action='store_true',
                        default=env.get('SKYTPU_SERVE_PREFIX_CACHE',
                                        '1') == '0',
                        help='No prompt prefix reuse across requests '
                             '(env SKYTPU_SERVE_PREFIX_CACHE=0).')
    parser.add_argument('--max-queue', type=int, default=0)
    parser.add_argument('--queue-ttl', type=float, default=None)
    parser.add_argument('--prefill-chunk', type=int, default=512)
    parser.add_argument('--temperature', type=float, default=0.0)
    parser.add_argument('--top-k', type=int, default=0)
    parser.add_argument('--seed', type=int, default=0,
                        help='Weight seed and default sampling seed.')
    parser.add_argument('--tensor', type=int, default=1,
                        help='Tensor-shard the model over N devices: '
                             'per-rank weight shards, row-parallel '
                             'reductions, a vocab-parallel head, a KV '
                             'pool per rank.')
    parser.add_argument('--tensor-devices', default=None,
                        help='Comma-separated devices of the tensor mesh '
                             '(may repeat one card: cuda:0,cuda:0); '
                             'default: the first --tensor visible cards.')
    parser.add_argument('--num-hosts', type=int,
                        default=int(env.get(
                            'SKYTPU_SERVE_REPLICA_NUM_HOSTS', '1')),
                        help='Serve this replica as a SLICE of N ranks: '
                             'ticks coordinated across ranks, long '
                             'prompts prefilled sequence-parallel (ring '
                             'attention).  Env '
                             'SKYTPU_SERVE_REPLICA_NUM_HOSTS.  Requires '
                             '--continuous-batching.')
    parser.add_argument('--sp-threshold', type=int,
                        default=(int(env['SKYTPU_SLICE_SP_THRESHOLD'])
                                 if env.get('SKYTPU_SLICE_SP_THRESHOLD')
                                 else None),
                        help='Prompt tokens at which a multi-host '
                             'replica prefills sequence-parallel in one '
                             'shot instead of chunked (default 1024; env '
                             'SKYTPU_SLICE_SP_THRESHOLD).')
    parser.add_argument('--slice-sequence', type=int, default=None,
                        help='Pin the sequence-axis factor of the slice '
                             'mesh (default: hosts left over after the '
                             'tensor factor).')
    parser.add_argument('--slice-tensor', type=int, default=None,
                        help='Pin the tensor-axis factor of the slice '
                             'mesh (default: the largest divisor of '
                             '--num-hosts the model shapes support).')
    parser.add_argument('--slice-devices', default=None,
                        help='Comma-separated devices of the slice\'s '
                             'ranks (may repeat one card: four entries of '
                             'cuda:0 emulate four hosts); default: the '
                             'visible cards.')
    parser.add_argument('--role',
                        default=os.environ.get('SKYTPU_SERVE_REPLICA_ROLE',
                                               roles_lib.DEFAULT_ROLE),
                        choices=list(roles_lib.ROLES),
                        help='Disaggregated-serving role this replica '
                             'advertises (env SKYTPU_SERVE_REPLICA_ROLE).')
    parser.add_argument('--http-server', default='async',
                        choices=['async', 'threaded'],
                        help='Connection front: one asyncio event loop '
                             '(default) or a thread per connection.')
    parser.add_argument('--checkpoint-dir', default=None,
                        help='The port\'s checkpoint dir (written by '
                             'python -m skypilot_tpu_torch.models.'
                             'import_weights); its newest step is served.')
    parser.add_argument('--tokenizer', default=None,
                        help='Tokenizer file/dir (default: tokenizer '
                             'files next to --checkpoint-dir, else the '
                             'byte-level fallback).')
    parser.add_argument('--quantize', default=None, choices=['int8'],
                        help='Weight-only int8 quantization of the matmul '
                             'kernels: half the weight bytes of bf16.')
    parser.add_argument('--device', default='cuda')
    return parser


def _device_list(text: Optional[str]) -> Optional[List[str]]:
    return None if not text else [d.strip() for d in text.split(',')]


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = ModelServer(args.model, checkpoint_dir=args.checkpoint_dir,
                         tokenizer_path=args.tokenizer,
                         quantize=args.quantize, max_len=args.max_len,
                         max_batch=args.max_batch, seed=args.seed,
                         continuous_batching=args.continuous_batching,
                         max_queue=args.max_queue, queue_ttl=args.queue_ttl,
                         prefill_chunk=args.prefill_chunk,
                         default_temperature=args.temperature,
                         default_top_k=args.top_k, default_seed=args.seed,
                         kv_pages=args.kv_pages, page_size=args.page_size,
                         quantize_kv=args.quantize_kv,
                         prefix_caching=not args.no_prefix_cache,
                         spec_tokens=args.spec_tokens, role=args.role,
                         tensor=args.tensor,
                         tensor_devices=_device_list(args.tensor_devices),
                         num_hosts=args.num_hosts,
                         sp_threshold=args.sp_threshold,
                         slice_sequence=args.slice_sequence,
                         slice_tensor=args.slice_tensor,
                         slice_devices=_device_list(args.slice_devices),
                         device=args.device)
    if args.http_server == 'async':
        from skypilot_tpu_torch.serve import async_server  # pylint: disable=import-outside-toplevel
        async_server.serve_forever(server, args.port)
    else:
        serve_forever(server, args.port)


if __name__ == '__main__':
    main()
