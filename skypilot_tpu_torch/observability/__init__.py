"""The replica's observability plane (the replica half of
`skypilot_tpu/observability/`, copied or ported):

- `metrics`: Counter/Gauge/Histogram instruments, the process-global
  registry and its Prometheus exposition (`GET /metrics`).
- `tracing`: request ids and per-request spans (queue wait, prefill,
  TTFT, ITL, total), exported as trace segments (`GET /spans`).
- `logs`: request-scoped structured log records in a bounded ring
  (`GET /logs`) and the HTTP access log.
- `profiling`: the tick-phase profiler and the shape sentinel
  (`GET /profile`).

Nothing here touches the device except the profiler's memory callback,
which reads the CUDA allocator's counters on the host.
"""
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import tracing

__all__ = ['metrics', 'tracing']
