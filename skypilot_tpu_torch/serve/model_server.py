"""Model server of the port: `ModelServer` + a threaded HTTP front
(mirrors `skypilot_tpu/serve/model_server.py`, the /health and
/generate routes with the same JSON).

    python -m skypilot_tpu_torch.serve.model_server --model llama3-8b \
        --continuous-batching --kv-pages 1024

- GET /health (and any other GET): {'status', 'model', 'device',
  'weight_version', 'engine': stats}; 503 once the engine failed.
- POST /generate {'prompt_ids': [[...], ...], 'max_new_tokens',
  'temperature', 'top_k', 'seed'} -> {'tokens', 'weight_version',
  'latency_ms'}.  400 for a malformed body, 429 + Retry-After when the
  admission queue or the page pool is full, 503 + Retry-After when the
  request expired queued, 504 past its deadline, 500 otherwise.

Weights are seeded random values made on the device (`init_params`);
checkpoint loading comes with a later slice of the port.
"""
from __future__ import annotations

import argparse
import json
import logging
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
from skypilot_tpu_torch.serve import batching_engine as batching_engine_lib
from skypilot_tpu_torch.serve import http_protocol

logger = logging.getLogger(__name__)


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
                 device: Union[str, torch.device] = 'cuda') -> None:
        self.device = resolve_device(device)
        self.cfg = configs.get_config(model)
        self.model_name = model
        self.tokenizer = tokenizer_lib.load_tokenizer(None)
        self.max_len = max_len
        self.max_batch = max_batch
        self.default_temperature = float(default_temperature)
        self.default_top_k = int(default_top_k)
        self.default_seed = int(default_seed)
        self.weight_version = 0
        logger.warning('No checkpoint loading in this port yet; serving '
                       'FRESH random-init weights (seed %d).', seed)
        self.params = init_params(self.cfg, seed=seed, device=self.device)
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

    @property
    def engine(self):
        return self._engine

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
            payload = server.health()
            self._reply(200 if payload['status'] == 'ok' else 503,
                        payload)

        def do_POST(self):
            path = self.path.partition('?')[0]
            if path != http_protocol.GENERATE:
                self._read_body()
                self._reply(404, {'error': 'unknown path'})
                return
            rid = self.headers.get(http_protocol.REQUEST_ID_HEADER)
            try:
                req = json.loads(self._read_body() or b'{}')
                if not isinstance(req, dict):
                    raise ValueError('body must be a JSON object')
                t0 = time.perf_counter()
                tokens = server.generate(
                    req['prompt_ids'], int(req.get('max_new_tokens', 16)),
                    float(req.get('temperature',
                                  server.default_temperature)),
                    int(req.get('top_k', server.default_top_k)),
                    seed=int(req.get('seed', server.default_seed)),
                    request_id=rid, deadline_ms=self._deadline_ms())
                headers = ({http_protocol.REQUEST_ID_HEADER: rid}
                           if rid else None)
                self._reply(200, {
                    'tokens': tokens,
                    'weight_version': server.weight_version,
                    'latency_ms': round(
                        (time.perf_counter() - t0) * 1e3, 1),
                }, headers)
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {'error': str(e)})
            except Exception as e:  # pylint: disable=broad-except
                # Engine failures must reach the client as an HTTP error
                # (admission pushback as 429/503/504), not a dropped
                # connection.
                if not self._reply_backpressure(e):
                    self._reply(500, {'error': f'{type(e).__name__}: {e}'})

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
                             '(needs --kv-pages).')
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
