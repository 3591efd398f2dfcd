"""Dependency-free metrics core with Prometheus text exposition (a copy
of `skypilot_tpu/observability/metrics.py`; the fleet scrapes both
packages' replicas with the same parser).

Three instrument kinds (Counter, Gauge, Histogram), each with optional
labels, registered in a process-global `Registry` whose `expose()`
renders the Prometheus text format (text/plain; version=0.0.4) that
`GET /metrics` on the serving fronts returns.

Design points:
- No prometheus_client dependency: the serving image stays minimal and
  the exposition format is small enough to own (HELP/TYPE lines,
  `name{label="value"} value`, histogram `_bucket`/`_sum`/`_count`).
- get-or-create constructors (`counter()`/`gauge()`/`histogram()`):
  module-level wiring can run more than once per process (tests build
  many engines); the same (name, labelnames) pair always resolves to
  the same instrument, and a conflicting redefinition raises instead
  of silently forking the series.
- Bounded label cardinality: each instrument folds label sets beyond
  `max_series` into one `_overflow_` child (logged once) — a buggy
  label (e.g. a raw URL with a query string) degrades the metric, not
  the process.
- Thread safety: every mutation happens under the instrument's lock;
  increments from the engine worker, HTTP threads, and the asyncio
  loop interleave freely (pinned by tests/test_torch_observability.py).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# Upper bounds (seconds) for latency histograms; chosen to straddle the
# serving SLO range (ms-scale ITL through minutes-scale queue waits).
LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
DEFAULT_BUCKETS = LATENCY_BUCKETS
# Per-instrument label-set cap; beyond it new label sets fold into one
# `_overflow_` series.
MAX_SERIES = 256

_OVERFLOW_KEY = '_overflow_'


def _escape_label_value(value: str) -> str:
    return (value.replace('\\', r'\\').replace('\n', r'\n')
            .replace('"', r'\"'))


def _format_series(name: str, labels: Sequence[Tuple[str, str]],
                   value: float) -> str:
    if labels:
        inner = ','.join(f'{k}="{_escape_label_value(str(v))}"'
                         for k, v in labels)
        return f'{name}{{{inner}}} {_format_value(value)}'
    return f'{name} {_format_value(value)}'


def _format_value(value: float) -> str:
    if value == float('inf'):
        return '+Inf'
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


class _Instrument:
    """Base: label-keyed children, overflow folding, a lock."""

    kind = 'untyped'

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = (),
                 max_series: int = MAX_SERIES) -> None:
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._overflowed = False
        if not self.labelnames:
            self._children[()] = self._new_child()

    # Subclasses return their per-series state object.
    def _new_child(self) -> Any:
        raise NotImplementedError

    def labels(self, *values: Any, **kwvalues: Any) -> '_Instrument':
        """A bound view of this instrument for one label set."""
        if kwvalues:
            if values:
                raise ValueError('pass label values positionally OR by '
                                 'name, not both')
            extra = set(kwvalues) - set(self.labelnames)
            if extra:
                raise ValueError(f'{self.name}: unknown labels {extra}')
            try:
                values = tuple(kwvalues[k] for k in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f'{self.name}: missing label {e}; '
                    f'declared labels are {self.labelnames}') from e
        if len(values) != len(self.labelnames):
            raise ValueError(
                f'{self.name} takes {len(self.labelnames)} label '
                f'value(s) {self.labelnames}, got {len(values)}')
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_series:
                    if not self._overflowed:
                        self._overflowed = True
                        logger.warning(
                            f'metric {self.name}: label cardinality '
                            f'exceeded {self.max_series}; folding new '
                            f'label sets into {_OVERFLOW_KEY!r}')
                    key = (_OVERFLOW_KEY,) * len(self.labelnames)
                    child = self._children.get(key)
                    if child is None:
                        child = self._new_child()
                        self._children[key] = child
                else:
                    child = self._new_child()
                    self._children[key] = child
        return _Bound(self, key, child)

    def _default_child(self) -> Any:
        if self.labelnames:
            raise ValueError(
                f'{self.name} has labels {self.labelnames}; call '
                f'.labels(...) first')
        return self._children[()]

    def series(self) -> Dict[Tuple[str, ...], Any]:
        """Snapshot of label-values -> per-series state (for tests and
        pretty-printers)."""
        with self._lock:
            return dict(self._children)

    def expose_lines(self, const: Sequence[Tuple[str, str]] = ()
                     ) -> List[str]:
        raise NotImplementedError

    def _header(self) -> List[str]:
        return [f'# HELP {self.name} {self.help}',
                f'# TYPE {self.name} {self.kind}']


class _Bound:
    """An instrument bound to one label set: forwards the mutators."""

    def __init__(self, parent: _Instrument, key: Tuple[str, ...],
                 child: Any) -> None:
        self._parent = parent
        self._key = key
        self._child = child

    def inc(self, amount: float = 1.0) -> None:
        self._parent._inc_child(self._child, amount)  # pylint: disable=protected-access

    def dec(self, amount: float = 1.0) -> None:
        self._parent._inc_child(self._child, -amount)  # pylint: disable=protected-access

    def set(self, value: float) -> None:
        self._parent._set_child(self._child, value)  # pylint: disable=protected-access

    def observe(self, value: float) -> None:
        self._parent._observe_child(self._child, value)  # pylint: disable=protected-access

    @property
    def value(self) -> float:
        return self._parent._read_child(self._child)  # pylint: disable=protected-access


class Counter(_Instrument):
    """Monotonically increasing count (use `_total` suffixed names)."""

    kind = 'counter'

    def _new_child(self) -> List[float]:
        return [0.0]

    def _inc_child(self, child: List[float], amount: float) -> None:
        if amount < 0:
            raise ValueError(f'{self.name}: counters only go up '
                             f'(inc {amount})')
        with self._lock:
            child[0] += amount

    def _read_child(self, child: List[float]) -> float:
        with self._lock:
            return child[0]

    def inc(self, amount: float = 1.0) -> None:
        self._inc_child(self._default_child(), amount)

    @property
    def value(self) -> float:
        return self._read_child(self._default_child())

    def expose_lines(self, const: Sequence[Tuple[str, str]] = ()
                     ) -> List[str]:
        lines = self._header()
        with self._lock:
            for key, child in sorted(self._children.items()):
                lines.append(_format_series(
                    self.name,
                    list(const) + list(zip(self.labelnames, key)),
                    child[0]))
        return lines


class Gauge(_Instrument):
    """A value that goes up and down (queue depth, busy slots)."""

    kind = 'gauge'

    def _new_child(self) -> List[float]:
        return [0.0]

    def _inc_child(self, child: List[float], amount: float) -> None:
        with self._lock:
            child[0] += amount

    def _set_child(self, child: List[float], value: float) -> None:
        with self._lock:
            child[0] = float(value)

    def _read_child(self, child: List[float]) -> float:
        with self._lock:
            return child[0]

    def inc(self, amount: float = 1.0) -> None:
        self._inc_child(self._default_child(), amount)

    def dec(self, amount: float = 1.0) -> None:
        self._inc_child(self._default_child(), -amount)

    def set(self, value: float) -> None:
        self._set_child(self._default_child(), value)

    @property
    def value(self) -> float:
        return self._read_child(self._default_child())

    def expose_lines(self, const: Sequence[Tuple[str, str]] = ()
                     ) -> List[str]:
        lines = self._header()
        with self._lock:
            for key, child in sorted(self._children.items()):
                lines.append(_format_series(
                    self.name,
                    list(const) + list(zip(self.labelnames, key)),
                    child[0]))
        return lines


class _HistChild:
    __slots__ = ('counts', 'total', 'count')

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * n_buckets   # per-bucket (non-cumulative)
        self.total = 0.0
        self.count = 0


class Histogram(_Instrument):
    """Observations bucketed by upper bound; exposed cumulatively with
    `le` labels plus `_sum`/`_count` (Prometheus histogram contract)."""

    kind = 'histogram'

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 max_series: int = MAX_SERIES) -> None:
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError('histogram needs at least one bucket')
        if any(b <= a for a, b in zip(buckets, buckets[1:])):
            raise ValueError(f'duplicate bucket bounds in {buckets}')
        self.buckets = buckets
        super().__init__(name, help_text, labelnames,
                         max_series=max_series)

    def _new_child(self) -> _HistChild:
        return _HistChild(len(self.buckets) + 1)  # +1: the +Inf bucket

    def _observe_child(self, child: _HistChild, value: float) -> None:
        idx = len(self.buckets)
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                idx = i
                break
        with self._lock:
            child.counts[idx] += 1
            child.total += value
            child.count += 1

    def _read_child(self, child: _HistChild) -> float:
        with self._lock:
            return child.count

    def observe(self, value: float) -> None:
        self._observe_child(self._default_child(), value)

    @property
    def count(self) -> int:
        child = self._default_child()
        with self._lock:
            return child.count

    @property
    def sum(self) -> float:
        child = self._default_child()
        with self._lock:
            return child.total

    def bucket_counts(self, *label_values: Any) -> List[int]:
        """Non-cumulative per-bucket counts (last = +Inf overflow)."""
        if self.labelnames:
            key = tuple(str(v) for v in label_values)
            with self._lock:
                child = self._children[key]
                return list(child.counts)
        child = self._default_child()
        with self._lock:
            return list(child.counts)

    def expose_lines(self, const: Sequence[Tuple[str, str]] = ()
                     ) -> List[str]:
        lines = self._header()
        with self._lock:
            for key, child in sorted(self._children.items()):
                base = list(const) + list(zip(self.labelnames, key))
                acc = 0
                for bound, n in zip(self.buckets, child.counts):
                    acc += n
                    lines.append(_format_series(
                        f'{self.name}_bucket',
                        base + [('le', _format_value(bound))], acc))
                acc += child.counts[-1]
                lines.append(_format_series(
                    f'{self.name}_bucket', base + [('le', '+Inf')], acc))
                lines.append(_format_series(f'{self.name}_sum', base,
                                            child.total))
                lines.append(_format_series(f'{self.name}_count', base,
                                            child.count))
        return lines


class Registry:
    """Named instruments -> one exposition document."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}
        # Constant process-identity labels stamped on EVERY exposed
        # series (replica_id / role / num_hosts on a serving replica):
        # the fleet aggregator's store keys series by their full label
        # set, so without these, same-named series scraped from
        # different replicas would collapse into one.
        self._const_labels: Tuple[Tuple[str, str], ...] = ()

    def set_const_labels(self, labels: Dict[str, Any]) -> None:
        """Install the constant labels appended to every series this
        registry exposes (sorted by label name for a stable format)."""
        with self._lock:
            self._const_labels = tuple(sorted(
                (str(k), str(v)) for k, v in labels.items()))

    def const_labels(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._const_labels)

    def register(self, metric: _Instrument) -> _Instrument:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                raise ValueError(
                    f'metric {metric.name!r} already registered')
            self._metrics[metric.name] = metric
        return metric

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get(name)

    def _get_or_create(self, cls, name: str, help_text: str,
                       labelnames: Sequence[str], **kwargs) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls or
                        existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f'metric {name!r} already registered as '
                        f'{type(existing).__name__}'
                        f'{existing.labelnames}; cannot redefine as '
                        f'{cls.__name__}{tuple(labelnames)}')
                return existing
            metric = cls(name, help_text, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help_text,
                                   labelnames, buckets=buckets)

    def expose(self) -> str:
        """The whole registry in Prometheus text format."""
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
            const = self._const_labels
        lines: List[str] = []
        for metric in metrics:
            lines.extend(metric.expose_lines(const))
        return '\n'.join(lines) + '\n'

    def clear(self) -> None:
        """Drop every instrument (tests only — wiring re-creates its
        instruments through the get-or-create constructors)."""
        with self._lock:
            self._metrics.clear()
            self._const_labels = ()


# The process-global registry every layer reports into; `GET /metrics`
# on the serving fronts exposes exactly this.
REGISTRY = Registry()

CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'


def counter(name: str, help_text: str,
            labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help_text, labelnames)


def gauge(name: str, help_text: str,
          labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help_text, labelnames)


def histogram(name: str, help_text: str,
              labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help_text, labelnames,
                              buckets=buckets)


def expose() -> str:
    return REGISTRY.expose()


def parse_exposition(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str],
                                                        ...], float]]:
    """Parse the text format back into {name: {labels: value}} — used
    by the round-trip tests, the CLI pretty-printer, and the
    bench_serve smoke scrape.  Labels are a sorted tuple of (k, v)."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        if '{' in line:
            name, rest = line.split('{', 1)
            label_str, value_str = rest.rsplit('} ', 1)
            labels = []
            for part in _split_labels(label_str):
                k, v = part.split('=', 1)
                labels.append((k, v.strip('"')
                               .replace(r'\"', '"')
                               .replace(r'\n', '\n')
                               .replace(r'\\', '\\')))
            key = tuple(sorted(labels))
        else:
            name, value_str = line.rsplit(' ', 1)
            key = ()
        value = float('inf') if value_str == '+Inf' else float(value_str)
        out.setdefault(name.strip(), {})[key] = value
    return out


def histogram_quantile(parsed: Dict[str, Dict[Tuple[Tuple[str, str],
                                                    ...], float]],
                       name: str, q: float) -> Optional[float]:
    """Quantile of an exposed Prometheus histogram, from
    `parse_exposition` output (the CLI tables and the fleet aggregator
    both feed through here).

    Buckets from every label set of `<name>_bucket` are summed per
    upper bound (an aggregated quantile across replicas/roles), then
    the quantile is read Prometheus-style: find the bucket where the
    cumulative count crosses q and interpolate LINEARLY inside it
    (lower edge = the previous bucket's bound, 0 for the first).  A
    quantile landing in the +Inf bucket clamps to the highest finite
    bound.  Returns None without data."""
    buckets = parsed.get(f'{name}_bucket')
    if not buckets:
        return None
    cum: Dict[float, float] = {}
    for labels, value in buckets.items():
        le = dict(labels).get('le')
        if le is None:
            continue
        bound = float('inf') if le == '+Inf' else float(le)
        cum[bound] = cum.get(bound, 0.0) + value
    rows = sorted(cum.items())
    if not rows or rows[-1][1] <= 0:
        return None
    total = rows[-1][1]
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, acc in rows:
        if acc >= target:
            if bound == float('inf'):
                # Prometheus convention: the +Inf bucket has no upper
                # edge to interpolate into; report the highest finite
                # bound (None when every observation overflowed).
                finite = [b for b, _ in rows if b != float('inf')]
                return finite[-1] if finite else None
            if acc == prev_cum:
                return bound
            frac = (target - prev_cum) / (acc - prev_cum)
            return prev_bound + (bound - prev_bound) * max(
                0.0, min(1.0, frac))
        prev_bound, prev_cum = bound, acc
    return rows[-1][0]


def _split_labels(label_str: str) -> Iterable[str]:
    """Split `k1="v1",k2="v2"` respecting escaped quotes."""
    parts, buf, in_quotes, escaped = [], [], False, False
    for ch in label_str:
        if escaped:
            buf.append(ch)
            escaped = False
            continue
        if ch == '\\':
            buf.append(ch)
            escaped = True
            continue
        if ch == '"':
            in_quotes = not in_quotes
            buf.append(ch)
            continue
        if ch == ',' and not in_quotes:
            parts.append(''.join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append(''.join(buf))
    return parts


def start_exposition_server(port: int = 0,
                            registry: Optional[Registry] = None):
    """Standalone `GET /metrics` endpoint over `registry` (default: the
    process-global one); returns (port, shutdown_fn).  Used where no
    serving front exists to piggyback on (bench_serve's smoke scrape,
    training jobs)."""
    import http.server  # pylint: disable=import-outside-toplevel
    reg = registry or REGISTRY

    class Handler(http.server.BaseHTTPRequestHandler):

        def log_message(self, *args):
            del args

        def do_GET(self):
            from skypilot_tpu_torch.serve import http_protocol  # pylint: disable=import-outside-toplevel
            if self.path not in (http_protocol.METRICS, '/'):
                self.send_response(404)
                self.end_headers()
                return
            body = reg.expose().encode()
            self.send_response(200)
            self.send_header('Content-Type', CONTENT_TYPE)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = http.server.ThreadingHTTPServer(('127.0.0.1', port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_port, httpd.shutdown


class Timer:
    """`with Timer(hist): ...` observes the block's wall time."""

    def __init__(self, hist) -> None:
        self._hist = hist
        self._t0 = 0.0

    def __enter__(self) -> 'Timer':
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *args: Any) -> None:
        self._hist.observe(time.perf_counter() - self._t0)
