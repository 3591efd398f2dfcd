"""Model server of the port: `ModelServer` + a threaded HTTP front
(mirrors `skypilot_tpu/serve/model_server.py`: the routes below, with
the same JSON, status codes and error mapping).

    python -m skypilot_tpu_torch.serve.model_server --model llama3-8b \
        --continuous-batching [--kv-pages 1024]

- GET /health (and any other GET): {'status', 'model', 'device',
  'weight_version', 'engine': stats}; 503 once the engine failed.
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
  request expired queued, 504 past its deadline, 500 otherwise.
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
- POST /weights_swap {'checkpoint_dir'}: 400 with the reason, since no
  checkpoint can be restored yet (orbax restore comes with a later
  slice); `ContinuousBatchingEngine.swap_params` is the engine half.
  `weight_version` follows the engine's weight epoch.

Weights are seeded random values made on the device (`init_params`),
or a given Transformer (`params`, e.g. one model shared by two
servers); checkpoint loading comes with a later slice of the port.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler
from http.server import ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Union

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import tokenizer as tokenizer_lib
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.observability import logs as logs_lib
from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve import batching_engine as batching_engine_lib
from skypilot_tpu_torch.serve import handoff as handoff_lib
from skypilot_tpu_torch.serve import http_protocol

logger = logging.getLogger(__name__)

# The port's replicas serve one role (the reference's default); roles
# and their budgets come with the rest of the replica front.
ROLE = 'mixed'

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


def model_flops_per_token(cfg, n_params: int, max_len: int) -> float:
    """Forward FLOPs per generated token: ~2 x params for the matmuls,
    plus attention over the mean decode context (max_len / 2): QK^T and
    attn x V cost 2 x n_heads x head_dim each per layer and position."""
    attn = (2.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim
            * float(max_len))
    return 2.0 * float(n_params) + attn


class ModelServer:

    def __init__(self, model: str, *, max_len: int = 512,
                 max_batch: int = 8, seed: int = 0,
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
                 device: Union[str, torch.device] = 'cuda',
                 params=None) -> None:
        self.device = resolve_device(device)
        self.cfg = configs.get_config(model)
        self.model_name = model
        self.tokenizer = tokenizer_lib.load_tokenizer(None)
        self.max_len = max_len
        self.max_batch = max_batch
        self.default_temperature = float(default_temperature)
        self.default_top_k = int(default_top_k)
        self.default_seed = int(default_seed)
        if params is None:
            logger.warning('No checkpoint loading in this port yet; '
                           'serving FRESH random-init weights (seed %d).',
                           seed)
            params = init_params(self.cfg, seed=seed, device=self.device)
        elif params.cfg != self.cfg or params.device != self.device:
            raise ValueError(f'params are not a {model} model on '
                             f'{self.device}')
        self.params = params
        # Process identity for fleet telemetry: the controller-set env
        # var names the replica; only then does this server own the
        # process-global registry's constant labels.
        env_rid = os.environ.get('SKYTPU_SERVE_REPLICA_ID')
        self.replica_id: Optional[int] = (
            int(env_rid) if env_rid and env_rid.isdigit() else None)
        self.role = ROLE
        self.num_hosts = 1
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
        n_params = sum(p.numel() for p in params.parameters())
        self.flops_per_token = model_flops_per_token(self.cfg, n_params,
                                                     max_len)
        _M_FLOPS_PER_TOKEN.set(self.flops_per_token)
        self._lock = threading.Lock()
        self._engine: Optional[
            batching_engine_lib.ContinuousBatchingEngine] = None
        if continuous_batching:
            self._engine = batching_engine_lib.ContinuousBatchingEngine(
                self.cfg, self.params, max_len=max_len, slots=max_batch,
                max_queue=max_queue, queue_ttl=queue_ttl,
                prefill_chunk=prefill_chunk, kv_pages=kv_pages,
                page_size=page_size, quantize_kv=quantize_kv,
                prefix_caching=prefix_caching, spec_tokens=spec_tokens,
                device=self.device)
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

    def weights_swap(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """POST /weights_swap: the reference restores the latest
        checkpoint under `checkpoint_dir` and swaps it into the engine.
        This port restores no checkpoints yet, so every request is
        answered with the reason (HTTP 400)."""
        if self._engine is None:
            raise ValueError('live weight swap requires '
                             '--continuous-batching')
        checkpoint_dir = req.get('checkpoint_dir')
        if not checkpoint_dir or not isinstance(checkpoint_dir, str):
            raise ValueError('weights_swap needs a checkpoint_dir')
        raise ValueError(f'no checkpoint under {checkpoint_dir} can be '
                         'restored: checkpoint loading comes with a later '
                         'slice of the port')

    def close(self) -> None:
        """Stop the batching engine's worker; safe to call twice."""
        if self._engine is not None:
            self._engine.stop()
            self._engine = None

    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int = 0,
                 stop_token=None, seed: int = 0,
                 request_id: Optional[str] = None,
                 deadline_ms: Optional[float] = None) -> List[List[int]]:
        """prompt_ids [batch][seq] -> new tokens per row.  Under
        continuous batching each row is its own engine request."""
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
                              deadline_ms=deadline_ms)
                for i, row in enumerate(rows)]
            return [list(r.result(timeout=600)) for r in requests]
        vocab = self.cfg.vocab_size
        if any(not 0 <= t < vocab for row in rows for t in row):
            raise ValueError(f'prompt ids must lie in [0, {vocab})')
        with self._lock:
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

    def health(self) -> Dict[str, Any]:
        payload = {'status': 'ok',
                   'model': f'{self.cfg.d_model}x{self.cfg.n_layers}',
                   'device': str(self.device),
                   'weight_version': self.weight_version}
        engine = self._engine
        if engine is not None:
            stats = engine.stats()
            payload['engine'] = stats
            if stats['failed']:
                payload['status'] = 'engine_failed'
        return payload


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

        def _deadline_ms(self) -> Optional[float]:
            raw = self.headers.get(http_protocol.DEADLINE_HEADER)
            if raw:
                try:
                    ms = float(raw)
                    return ms if ms > 0 else None
                except ValueError:
                    pass
            return None

        def do_GET(self):
            route = self._begin() or logs_lib.HEALTH_ROUTE
            with logs_lib.bind(request_id=self._rid, process='replica',
                               replica_id=server.replica_id,
                               role=server.role):
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
                payload = server.health()
                self._reply(200 if payload['status'] == 'ok' else 503,
                            payload)

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

        def _sse_stream(self, request, events) -> None:
            """Answer with the SSE frames `events` yields from the
            request's token stream, then [DONE]; a client that goes
            away, or any other failure, cancels the request."""
            self._start_sse()
            try:
                for data in events:
                    self._sse_chunk(data)
                self._sse_chunk('[DONE]')
                self.wfile.write(b'0\r\n\r\n')
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

        def _generate(self):
            try:
                req = self._read_json()
                t0 = time.perf_counter()
                temperature, top_k, seed = self._sampling(req)
                tokens = server.generate(
                    req['prompt_ids'], int(req.get('max_new_tokens', 16)),
                    temperature, top_k, seed=seed, request_id=self._rid,
                    deadline_ms=self._deadline_ms())
                self._reply(200, {
                    'tokens': tokens,
                    'weight_version': server.weight_version,
                    'latency_ms': round(
                        (time.perf_counter() - t0) * 1e3, 1),
                })
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
                    request_id=self._rid, deadline_ms=self._deadline_ms())
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {'error': str(e)})
                return
            except Exception as e:  # pylint: disable=broad-except
                # A stopped or failed engine (503) or a full queue (429).
                if not self._reply_backpressure(e):
                    self._reply(503, {'error': f'{type(e).__name__}: {e}'})
                return
            self._sse_stream(request, (
                json.dumps({'token': token})
                for token in request.stream(timeout=600)))

        def _generate_text(self):
            """Text in, text out through the server's tokenizer; with
            {"stream": true} SSE {"text": delta} events."""
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
                        deadline_ms=self._deadline_ms())
                    self._sse_stream(request,
                                     self._text_events(tok, request))
                    return
                t0 = time.perf_counter()
                tokens = server.generate(
                    [ids], max_new, temperature, top_k,
                    stop_token=tok.eos_ids or None, seed=seed,
                    request_id=self._rid,
                    deadline_ms=self._deadline_ms())[0]
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
                    (time.perf_counter() - t0) * 1e3, tokens=len(prompt))
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
                http_protocol.WEIGHTS_SWAP: self._weights_swap,
            }.get(route)
            with logs_lib.bind(request_id=self._rid, process='replica',
                               replica_id=server.replica_id,
                               role=server.role):
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


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny',
                        help=f'Preset name: {sorted(configs.PRESETS)}.')
    parser.add_argument('--port', type=int, default=8080)
    parser.add_argument('--max-len', type=int, default=512)
    parser.add_argument('--max-batch', type=int, default=8)
    parser.add_argument('--continuous-batching', action='store_true',
                        help='Slot-pool scheduling with pipelined ticks '
                             '(a dense slot cache unless --kv-pages).')
    parser.add_argument('--kv-pages', type=int, default=None,
                        help='Paged KV cache: a pool of N pages.')
    parser.add_argument('--page-size', type=int, default=16)
    parser.add_argument('--quantize-kv', action='store_true',
                        help='int8 KV pages with per-token scales.')
    parser.add_argument('--spec-tokens', type=int, default=0,
                        help='Self-speculative decoding: N n-gram drafts '
                             'per slot verified in one tick (0 = off).')
    parser.add_argument('--no-prefix-cache', action='store_true')
    parser.add_argument('--max-queue', type=int, default=0)
    parser.add_argument('--queue-ttl', type=float, default=None)
    parser.add_argument('--prefill-chunk', type=int, default=512)
    parser.add_argument('--temperature', type=float, default=0.0)
    parser.add_argument('--top-k', type=int, default=0)
    parser.add_argument('--seed', type=int, default=0,
                        help='Weight seed and default sampling seed.')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = ModelServer(args.model, max_len=args.max_len,
                         max_batch=args.max_batch, seed=args.seed,
                         continuous_batching=args.continuous_batching,
                         max_queue=args.max_queue, queue_ttl=args.queue_ttl,
                         prefill_chunk=args.prefill_chunk,
                         default_temperature=args.temperature,
                         default_top_k=args.top_k, default_seed=args.seed,
                         kv_pages=args.kv_pages, page_size=args.page_size,
                         quantize_kv=args.quantize_kv,
                         prefix_caching=not args.no_prefix_cache,
                         spec_tokens=args.spec_tokens, device=args.device)
    serve_forever(server, args.port)


if __name__ == '__main__':
    main()
