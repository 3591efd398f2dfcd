"""Asyncio HTTP front of the port's replica (mirrors
`skypilot_tpu/serve/async_server.py`; `model_server.main` serves
through it unless `--http-server threaded` is given).

One event loop owns every socket: concurrent SSE streams, probes and
JSON requests never take a thread per connection.  Tokens reach a
stream through the engine request's watcher hook (`Request.add_watcher`
-> `loop.call_soon_threadsafe` -> an `asyncio.Queue`), so a stream wakes
only when its request produces a token.  Work that blocks (waiting for
`/generate`'s results, the lock-step decode of a server without an
engine, a KV export or import) runs in the loop's default executor;
`ModelServer.generate` and the engine's export enter the server's
device (and the engine's stream) in that thread, since PyTorch keeps
the current device and stream per thread.

The routes, JSON and status codes of the reference's front: GET
/metrics, /spans, /profile, /logs and the health payload on any other
GET; POST /generate, /generate_stream, /generate_text, /drain,
/role_budget, /weights_swap, /prefix_export, /prefill_export,
/kv_import; keep-alive connections; 429 / 503 + Retry-After for a full
queue, an expired request and a draining replica; 504 past a deadline.
A /generate sent with `Connection: close` gets the one-shot disconnect
watchdog: an EOF on the socket while it runs cancels its requests.  As
on the threaded front, every response echoes X-SkyTPU-Request-Id (the
request's own or a new one), and each request gets an access-log record
under its id.
"""
from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import tokenizer as tokenizer_lib
from skypilot_tpu_torch.observability import logs as logs_lib
from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve import batching_engine as batching_engine_lib
from skypilot_tpu_torch.serve import handoff as handoff_lib
from skypilot_tpu_torch.serve import http_protocol
from skypilot_tpu_torch.serve import model_server as model_server_lib
from skypilot_tpu_torch.serve import qos as qos_lib

logger = logging.getLogger(__name__)

_MAX_BODY = 64 * 1024 * 1024
_IDLE_TIMEOUT = 300.0
_REASONS = {200: 'OK', 400: 'Bad Request', 404: 'Not Found',
            408: 'Request Timeout', 413: 'Payload Too Large',
            429: 'Too Many Requests', 500: 'Internal Server Error',
            503: 'Service Unavailable', 504: 'Gateway Timeout'}


class _Headers(dict):
    """Request headers keyed by lower-cased name; `get` takes any case."""

    def get(self, key, default=None):
        return super().get(key.lower(), default)


class _HttpError(Exception):

    def __init__(self, code: int, message: str,
                 headers: Optional[Dict[str, str]] = None) -> None:
        super().__init__(message)
        self.code = code
        self.headers = headers or {}


def _backpressure_error(e: Exception) -> Optional[_HttpError]:
    """429 + Retry-After for a full queue or pool, 503 + Retry-After
    for a request that expired queued, 504 past its deadline."""
    if isinstance(e, batching_engine_lib.QueueFull):
        return _HttpError(429, str(e),
                          {'Retry-After': str(int(e.retry_after))})
    if isinstance(e, batching_engine_lib.QueueExpired):
        return _HttpError(503, str(e),
                          {'Retry-After': str(int(e.retry_after))})
    if isinstance(e, batching_engine_lib.DeadlineExceeded):
        return _HttpError(504, str(e))
    return None


async def _read_request(reader: asyncio.StreamReader
                        ) -> Optional[Tuple[str, str, _Headers, bytes]]:
    """(method, path, headers, body), or None on a clean EOF or an idle
    connection."""
    try:
        head = await asyncio.wait_for(reader.readuntil(b'\r\n\r\n'),
                                      timeout=_IDLE_TIMEOUT)
    except (asyncio.IncompleteReadError, ConnectionResetError,
            asyncio.TimeoutError):
        return None
    lines = head.decode('latin-1').split('\r\n')
    try:
        method, path, _ = lines[0].split(' ', 2)
    except ValueError as e:
        raise _HttpError(400, f'bad request line: {lines[0]!r}') from e
    headers = _Headers()
    for line in lines[1:]:
        if ':' in line:
            k, v = line.split(':', 1)
            headers[k.strip().lower()] = v.strip()
    try:
        length = int(headers.get('content-length', 0))
    except ValueError as e:
        raise _HttpError(400, 'bad Content-Length') from e
    if length > _MAX_BODY:
        raise _HttpError(413, 'request body too large')
    body = b''
    if length:
        # The head's idle bound: a client that stalls after its headers
        # must not hold a task and a socket forever.
        try:
            body = await asyncio.wait_for(reader.readexactly(length),
                                          timeout=_IDLE_TIMEOUT)
        except asyncio.TimeoutError as e:
            raise _HttpError(408, 'request body timed out') from e
    return method, path, headers, body


def _response(code: int, body: bytes, content_type: str,
              headers: Optional[Dict[str, str]] = None) -> bytes:
    extra = ''.join(f'{k}: {v}\r\n' for k, v in (headers or {}).items())
    return (f'HTTP/1.1 {code} {_REASONS.get(code, "Error")}\r\n'
            f'Content-Type: {content_type}\r\n'
            f'Content-Length: {len(body)}\r\n'
            f'{extra}\r\n').encode() + body


def _json_response(code: int, payload: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> bytes:
    return _response(code, json.dumps(payload).encode(),
                     'application/json', headers)


def _sse_chunk(data: str) -> bytes:
    payload = f'data: {data}\n\n'.encode()
    return f'{len(payload):x}\r\n'.encode() + payload + b'\r\n'


def _one_prompt(req: Dict[str, Any], what: str):
    prompt = req['prompt_ids']
    if isinstance(prompt, list) and prompt and isinstance(prompt[0], list):
        if len(prompt) != 1:
            raise _HttpError(400, f'{what} serves one prompt per request')
        prompt = prompt[0]
    return prompt


def _wants_binary(req: Dict[str, Any], headers: _Headers) -> bool:
    return (req.get('wire') == 'binary' or
            handoff_lib.CONTENT_TYPE_BINARY in (headers.get('accept') or ''))


class AsyncModelServer:
    """Serves a ModelServer's model and engine from one asyncio loop."""

    def __init__(self, server: model_server_lib.ModelServer) -> None:
        self.server = server
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    # ------------------------------------------------------------ bridge

    def _watch(self, request) -> asyncio.Queue:
        """The engine request's tokens (then None) on this loop."""
        q: asyncio.Queue = asyncio.Queue()
        loop = self._loop
        request.add_watcher(
            lambda token: loop.call_soon_threadsafe(q.put_nowait, token))
        return q

    async def _in_executor(self, fn):
        """fn() on an executor thread, with this task's log context."""
        return await asyncio.get_running_loop().run_in_executor(
            None, logs_lib.wrap_context(fn))

    def _sampling(self, req: Dict[str, Any]):
        """(temperature, top_k, seed): the request's, else the server's
        defaults."""
        server = self.server
        return (float(req.get('temperature', server.default_temperature)),
                int(req.get('top_k', server.default_top_k)),
                int(req.get('seed', server.default_seed)))

    def _reject_if_draining(self) -> None:
        """503 + Retry-After for new generation work on a draining
        replica (the LB's same-role retry lands it on a sibling)."""
        if self.server.draining:
            model_server_lib._M_DRAIN_REJECTED.inc()  # pylint: disable=protected-access
            raise _HttpError(503, 'replica is draining',
                             {'Retry-After': '5'})

    def _require_engine(self, what: str):
        engine = self.server.engine
        if engine is None:
            raise _HttpError(400, f'{what} requires --continuous-batching')
        return engine

    # --------------------------------------------------------- endpoints

    async def _generate(self, req: Dict[str, Any], rid: str,
                        headers: _Headers,
                        reader: asyncio.StreamReader) -> Dict[str, Any]:
        t0 = time.perf_counter()
        temperature, top_k, seed = self._sampling(req)
        qos_class = model_server_lib.parse_qos_class(headers)
        route_meta = model_server_lib.parse_route_meta(headers)
        deadline_ms = model_server_lib.parse_deadline_ms(headers)
        handles: list = []
        hung_up = threading.Event()

        def on_submit(requests) -> None:
            # A client can hang up before the executor has submitted:
            # whichever of the two comes second cancels.
            handles.extend(requests)
            if hung_up.is_set():
                for request in requests:
                    request.cancel()

        def call():
            return self.server.generate(
                req['prompt_ids'], int(req.get('max_new_tokens', 16)),
                temperature, top_k, seed=seed, request_id=rid,
                route_meta=route_meta, deadline_ms=deadline_ms,
                qos_class=qos_class, on_submit=on_submit)
        gen = asyncio.ensure_future(self._in_executor(call))
        if 'close' in (headers.get('connection') or '').lower():
            # Connection: close (the LB's routed path, one-shot clients):
            # no more request bytes may come, so a read that ends is the
            # client hanging up: cancel its requests (the worker frees
            # the slots) instead of decoding for nobody.
            watchdog = asyncio.ensure_future(reader.read(1))
            try:
                done, _ = await asyncio.wait(
                    {gen, watchdog}, return_when=asyncio.FIRST_COMPLETED)
            finally:
                watchdog.cancel()
                # The read must be gone before the connection's next
                # read starts: a stream takes one waiting reader.
                await asyncio.gather(watchdog, return_exceptions=True)
            if gen not in done:
                hung_up.set()
                for handle in list(handles):
                    handle.cancel()
                try:
                    await gen   # returns once the worker reaps them
                except Exception:  # pylint: disable=broad-except
                    pass
                raise model_server_lib.ClientDisconnected(
                    'client disconnected mid-generation')
        tokens = await gen
        model_server_lib._maybe_journal_request(  # pylint: disable=protected-access
            'serve_request_done', request_id=rid, status='ok',
            tokens=sum(len(t) for t in tokens))
        if qos_class == qos_lib.BATCH:
            model_server_lib._M_BATCH_ROWS.inc(len(tokens))  # pylint: disable=protected-access
        return {'tokens': tokens,
                'weight_version': self.server.weight_version,
                'latency_ms': round((time.perf_counter() - t0) * 1e3, 1)}

    async def _generate_text(self, req: Dict[str, Any], rid: str,
                             headers: _Headers,
                             writer: asyncio.StreamWriter) -> None:
        self._reject_if_draining()
        server = self.server
        tok = server.tokenizer
        if server.cfg.vocab_size < tok.vocab_size:
            raise _HttpError(
                400, f'model vocab {server.cfg.vocab_size} < tokenizer '
                     f'vocab {tok.vocab_size}: checkpoint and tokenizer '
                     'do not match')
        text = req.get('prompt')
        if not isinstance(text, str) or not text:
            raise _HttpError(400, 'prompt must be a non-empty string')
        ids = tok.encode(text, add_bos=True)
        if not ids:
            raise _HttpError(400, 'prompt tokenized to nothing')
        if req.get('stream'):
            await self._stream(writer, ids, req, rid, headers,
                               text_mode=True)
            return
        t0 = time.perf_counter()
        temperature, top_k, seed = self._sampling(req)
        tokens = (await self._in_executor(lambda: server.generate(
            [ids], int(req.get('max_new_tokens', 64)), temperature, top_k,
            stop_token=tok.eos_ids or None, seed=seed, request_id=rid,
            route_meta=model_server_lib.parse_route_meta(headers),
            deadline_ms=model_server_lib.parse_deadline_ms(headers),
            qos_class=model_server_lib.parse_qos_class(headers))))[0]
        stops = [i for i, t in enumerate(tokens) if t in tok.eos_ids]
        if stops:
            tokens = tokens[:stops[0]]
        writer.write(_json_response(200, {
            'completion': tok.decode(tokens), 'tokens': tokens,
            'latency_ms': round((time.perf_counter() - t0) * 1e3, 1),
        }, {http_protocol.REQUEST_ID_HEADER: rid}))
        await writer.drain()

    async def _stream(self, writer: asyncio.StreamWriter, ids,
                      req: Dict[str, Any], rid: str, headers: _Headers, *,
                      text_mode: bool) -> None:
        """SSE over chunked transfer: {"token": N} events, or UTF-8-safe
        {"text": delta} events in text mode, then [DONE].  No thread
        waits: the request's watcher wakes this task."""
        self._reject_if_draining()
        engine = self._require_engine('streaming')
        tok = self.server.tokenizer
        # Text mode stops at the tokenizer's stop set; token mode keeps
        # the request's own stop_token (which may be the int 0).
        stop_ids = ((tok.eos_ids or None) if text_mode
                    else req.get('stop_token'))
        temperature, top_k, seed = self._sampling(req)
        try:
            request = engine.submit(
                [int(t) for t in ids],
                int(req.get('max_new_tokens', 64 if text_mode else 16)),
                stop_token=stop_ids,
                sampling=decode.SamplingConfig(
                    temperature=temperature, top_k=top_k, seed=seed),
                request_id=rid,
                route_meta=model_server_lib.parse_route_meta(headers),
                deadline_ms=model_server_lib.parse_deadline_ms(headers),
                qos_class=model_server_lib.parse_qos_class(headers))
        except ValueError:
            raise
        except Exception as e:  # pylint: disable=broad-except
            # A full queue: 429; a stopped or failed engine: 503.
            bp = _backpressure_error(e)
            if bp is not None:
                raise bp from e
            raise _HttpError(503, f'{type(e).__name__}: {e}') from e
        q = self._watch(request)
        writer.write(b'HTTP/1.1 200 OK\r\n'
                     b'Content-Type: text/event-stream\r\n'
                     b'Cache-Control: no-cache\r\n' +
                     f'{http_protocol.REQUEST_ID_HEADER}: {rid}\r\n'.encode()
                     + b'Transfer-Encoding: chunked\r\n\r\n')
        decoder = tokenizer_lib.StreamDecoder(tok) if text_mode else None
        try:
            while True:
                token = await asyncio.wait_for(q.get(), timeout=600)
                if token is None:
                    if request.error is not None:
                        raise request.error
                    break
                if text_mode:
                    if token in tok.eos_ids:
                        break
                    delta = decoder.push(token)
                    if delta:
                        writer.write(_sse_chunk(json.dumps({'text': delta})))
                else:
                    writer.write(_sse_chunk(json.dumps({'token': token})))
                await writer.drain()
            if decoder is not None:
                tail = decoder.finish()
                if tail:
                    writer.write(_sse_chunk(json.dumps({'text': tail})))
            writer.write(_sse_chunk('[DONE]') + b'0\r\n\r\n')
            await writer.drain()
        except (BrokenPipeError, ConnectionResetError):
            # The client went away: free the slot instead of decoding
            # the rest of max_new_tokens for nobody.
            request.cancel()
        except asyncio.CancelledError:
            request.cancel()   # loop shutdown: free the slot, re-raise
            raise
        except Exception as e:  # pylint: disable=broad-except
            request.cancel()
            try:
                writer.write(_sse_chunk(json.dumps(
                    {'error': f'{type(e).__name__}: {e}'})) + b'0\r\n\r\n')
                await writer.drain()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass

    async def _prefill_export(self, req: Dict[str, Any], rid: str,
                              headers: _Headers,
                              echo: Dict[str, str]) -> bytes:
        """KV handoff, prefill side (the prefill runs in the executor, on
        the engine's stream, so streams on this loop keep flowing)."""
        engine = self._require_engine('KV handoff')
        self._reject_if_draining()
        prompt = _one_prompt(req, 'export')
        binary = _wants_binary(req, headers)
        t0, wall0 = time.perf_counter(), time.time()
        try:
            result = await self._in_executor(lambda: engine.export_prefill(
                [int(t) for t in prompt], page_size=req.get('page_size'),
                binary=binary))
        except handoff_lib.HandoffError as e:
            raise _HttpError(400, str(e)) from e
        self.server.record_handoff_segment(
            'prefill_export', rid, wall0, (time.perf_counter() - t0) * 1e3,
            attempt=model_server_lib.parse_attempt(
                headers.get(http_protocol.ATTEMPT_HEADER)),
            tokens=len(prompt))
        if binary:
            return _response(200, result, handoff_lib.CONTENT_TYPE_BINARY,
                             echo)
        return _json_response(200, result, echo)

    async def _kv_import(self, decoded: Dict[str, Any], rid: str,
                         headers: _Headers,
                         echo: Dict[str, str]) -> bytes:
        """KV handoff, decode side (waits on the engine worker in the
        executor).  `decoded`: handoff.decode_payload / decode_binary's
        dict."""
        engine = self._require_engine('KV handoff')
        self._reject_if_draining()   # imported pages would die here
        t0, wall0 = time.perf_counter(), time.time()
        try:
            imported, cached = await self._in_executor(
                lambda: engine.import_pages(
                    decoded['hashes'], decoded['page_size'], decoded['k'],
                    decoded['v'], k_scale=decoded.get('k_scale'),
                    v_scale=decoded.get('v_scale')))
        except handoff_lib.HandoffRejected as e:
            raise _HttpError(503, str(e)) from e
        except handoff_lib.HandoffError as e:
            raise _HttpError(400, str(e)) from e
        self.server.record_handoff_segment(
            'kv_import', rid, wall0, (time.perf_counter() - t0) * 1e3,
            attempt=model_server_lib.parse_attempt(
                headers.get(http_protocol.ATTEMPT_HEADER)),
            imported_pages=imported, cached_pages=cached)
        return _json_response(200, {'imported_pages': imported,
                                     'cached_pages': cached}, echo)

    async def _prefix_export(self, req: Dict[str, Any], headers: _Headers,
                             echo: Dict[str, str]) -> bytes:
        """Drain-time sibling handoff: the hottest prefix-cache pages
        (no prefill runs); allowed while draining."""
        engine = self._require_engine('prefix export')
        binary = _wants_binary(req, headers)
        try:
            result = await self._in_executor(
                lambda: engine.export_prefix_pages(
                    max_pages=int(req.get('max_pages', 64)),
                    binary=binary))
        except handoff_lib.HandoffError as e:
            raise _HttpError(404, str(e)) from e
        if binary:
            return _response(200, result, handoff_lib.CONTENT_TYPE_BINARY,
                             echo)
        return _json_response(200, result, echo)

    # ------------------------------------------------------- connection

    def _get(self, path: str, query: str,
             echo: Dict[str, str]) -> Tuple[int, bytes]:
        """(status, response) of a GET."""
        server = self.server
        if path == http_protocol.METRICS:
            engine = server.engine
            if engine is not None:
                engine.stats()   # freshen the scrape-time gauges
            return 200, _response(200, metrics_lib.expose().encode(),
                                  metrics_lib.CONTENT_TYPE, echo)
        if path == http_protocol.SPANS:
            payload = server.export_spans(**tracing.parse_span_query(query))
        elif path == http_protocol.PROFILE:
            payload = server.export_profile()
        elif path == http_protocol.LOGS:
            payload = {'records': logs_lib.get_ring().export(
                **logs_lib.parse_log_query(query))}
        else:
            code, payload = server.health()
            return code, _json_response(code, payload, echo)
        return 200, _json_response(200, payload, echo)

    async def _post(self, path: str, headers: _Headers, body: bytes,
                    rid: str, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> Optional[bytes]:
        """The response to a POST, or None when the route wrote it."""
        echo = {http_protocol.REQUEST_ID_HEADER: rid}
        server = self.server
        ctype = headers.get('content-type') or ''
        if (path == http_protocol.KV_IMPORT and
                handoff_lib.CONTENT_TYPE_BINARY in ctype):
            # The binary frame: raw array bytes, no JSON parse.
            try:
                decoded = handoff_lib.decode_binary(body)
            except handoff_lib.HandoffError as e:
                raise _HttpError(400, str(e)) from e
            return await self._kv_import(decoded, rid, headers, echo)
        try:
            req = json.loads(body or b'{}')
        except json.JSONDecodeError as e:
            raise _HttpError(400, f'bad JSON: {e}') from e
        if not isinstance(req, dict):
            raise _HttpError(400, 'body must be a JSON object')
        if path == http_protocol.GENERATE:
            self._reject_if_draining()
            return _json_response(
                200, await self._generate(req, rid, headers, reader), echo)
        if path == http_protocol.GENERATE_STREAM:
            await self._stream(writer, _one_prompt(req, 'streaming'), req,
                               rid, headers, text_mode=False)
            return None
        if path == http_protocol.GENERATE_TEXT:
            await self._generate_text(req, rid, headers, writer)
            return None
        if path == http_protocol.DRAIN:
            return _json_response(200, server.drain(), echo)
        if path == http_protocol.ROLE_BUDGET:
            return _json_response(200, server.apply_role_budget(req), echo)
        if path == http_protocol.WEIGHTS_SWAP:
            # Blocking (a checkpoint restore): streams keep flowing.
            return _json_response(200, await self._in_executor(
                lambda: server.weights_swap(req)), echo)
        if path == http_protocol.PREFIX_EXPORT:
            return await self._prefix_export(req, headers, echo)
        if path == http_protocol.PREFILL_EXPORT:
            return await self._prefill_export(req, rid, headers, echo)
        if path == http_protocol.KV_IMPORT:
            try:
                decoded = handoff_lib.decode_payload(req)
            except handoff_lib.HandoffError as e:
                raise _HttpError(400, str(e)) from e
            return await self._kv_import(decoded, rid, headers, echo)
        raise _HttpError(404, 'unknown path')

    async def _serve_one(self, method: str, path: str, headers: _Headers,
                         body: bytes, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> int:
        """Answer one request; returns the status that went out (0 when
        nothing did: a client that went away)."""
        path, _, query = path.partition('?')
        rid = (headers.get(http_protocol.REQUEST_ID_HEADER) or
               tracing.new_request_id())
        echo = {http_protocol.REQUEST_ID_HEADER: rid}
        try:
            if method == 'GET':
                status, response = self._get(path, query, echo)
            elif method == 'POST':
                response = await self._post(path, headers, body, rid,
                                            reader, writer)
                if response is None:
                    return 200   # a stream: its head went out with 200
                status = 200
            else:
                raise _HttpError(404, 'unknown method')
        except model_server_lib.ClientDisconnected:
            raise
        except _HttpError as e:
            status = e.code
            response = _json_response(e.code, {'error': str(e)},
                                      dict(e.headers, **echo))
        except (KeyError, ValueError, TypeError) as e:
            status = 400
            response = _json_response(400, {'error': str(e)}, echo)
        except (BrokenPipeError, ConnectionResetError):
            raise
        except Exception as e:  # pylint: disable=broad-except
            # Engine failures reach the client as HTTP, admission
            # pushback as 429/503 + Retry-After.
            bp = _backpressure_error(e)
            if bp is not None:
                status = bp.code
                response = _json_response(bp.code, {'error': str(bp)},
                                          dict(bp.headers, **echo))
            else:
                status = 500
                response = _json_response(
                    500, {'error': f'{type(e).__name__}: {e}'}, echo)
        writer.write(response)
        await writer.drain()
        return status

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        server = self.server
        try:
            while True:
                try:
                    parsed = await _read_request(reader)
                except _HttpError as e:
                    # Malformed request line, Content-Length or size:
                    # answer, then drop the connection (its framing is
                    # lost).
                    writer.write(_json_response(e.code, {'error': str(e)}))
                    await writer.drain()
                    break
                except (asyncio.LimitOverrunError, ValueError) as e:
                    writer.write(_json_response(
                        400, {'error': f'bad request: {e}'}))
                    await writer.drain()
                    break
                if parsed is None:
                    break
                method, path, headers, body = parsed
                bare = path.partition('?')[0]
                route = (bare if bare in http_protocol.REPLICA_PATHS
                         else (logs_lib.HEALTH_ROUTE if method == 'GET'
                               else 'unknown'))
                status = 0
                with logs_lib.bind(
                        request_id=headers.get(
                            http_protocol.REQUEST_ID_HEADER),
                        attempt=model_server_lib.parse_attempt(
                            headers.get(http_protocol.ATTEMPT_HEADER)),
                        process='replica', replica_id=server.replica_id,
                        role=server.role):
                    try:
                        status = await self._serve_one(
                            method, path, headers, body, reader, writer)
                    except model_server_lib.ClientDisconnected:
                        break   # no reply owed; the slots are freed
                    finally:
                        logs_lib.access_log(logger, method, route, status)
        except (BrokenPipeError, ConnectionResetError,
                asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (BrokenPipeError, ConnectionResetError, OSError,
                    RuntimeError):
                # RuntimeError: the loop closed during shutdown.
                pass

    # ------------------------------------------------------------ server

    async def run(self, host: str = '0.0.0.0', port: int = 0,
                  ready: Optional[asyncio.Future] = None) -> None:
        self._loop = asyncio.get_running_loop()
        server = await asyncio.start_server(self._handle, host, port)
        bound = server.sockets[0].getsockname()[1]
        logger.info('async model server on :%d', bound)
        if ready is not None:
            ready.set_result(bound)
        async with server:
            await server.serve_forever()


def serve_forever(server: model_server_lib.ModelServer,
                  port: int = 0) -> None:
    try:
        asyncio.run(AsyncModelServer(server).run(port=port))
    finally:
        server.close()


def start_background(server: model_server_lib.ModelServer, port: int = 0,
                     host: str = '127.0.0.1'):
    """Run the async front on a daemon thread's event loop; returns
    (port, shutdown).  shutdown cancels every task of the loop (streams
    cancel their requests) and closes the listening socket."""
    front = AsyncModelServer(server)
    loop = asyncio.new_event_loop()
    ready: asyncio.Future = loop.create_future()
    boot_error: list = []

    def run() -> None:
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(front.run(host, port, ready))
        except asyncio.CancelledError:
            pass
        except Exception as e:  # pylint: disable=broad-except
            boot_error.append(e)   # e.g. EADDRINUSE before ready
        finally:
            loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    while not ready.done():
        if not thread.is_alive():
            raise RuntimeError(
                'async server failed to start: '
                f'{boot_error[0] if boot_error else "unknown"}')
        time.sleep(0.01)

    def shutdown() -> None:
        def cancel_all() -> None:
            for task in asyncio.all_tasks(loop):
                task.cancel()
        loop.call_soon_threadsafe(cancel_all)
        thread.join(timeout=10)

    return ready.result(), shutdown
