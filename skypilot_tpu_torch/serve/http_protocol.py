"""HTTP routes and headers of the port's replica front (copied from
`skypilot_tpu/serve/http_protocol.py`, its "replica front" block; the
control routes /drain and /role_budget come with a later slice)."""
from __future__ import annotations

REQUEST_ID_HEADER = 'X-SkyTPU-Request-Id'
DEADLINE_HEADER = 'X-SkyTPU-Deadline-Ms'

HEALTH = '/health'                    # GET: health/readiness payload
METRICS = '/metrics'                  # GET: Prometheus exposition
SPANS = '/spans'                      # GET: trace-segment export
PROFILE = '/profile'                  # GET: tick-phase profiling ring
LOGS = '/logs'                        # GET: structured log-ring export
GENERATE = '/generate'                # POST: batch token generation
GENERATE_STREAM = '/generate_stream'  # POST: SSE token stream
GENERATE_TEXT = '/generate_text'      # POST: text in/out (tokenizer)
PREFILL_EXPORT = '/prefill_export'    # POST: KV handoff, prefill side
KV_IMPORT = '/kv_import'              # POST: KV handoff, decode side
PREFIX_EXPORT = '/prefix_export'      # POST: drain-time sibling handoff
WEIGHTS_SWAP = '/weights_swap'        # POST: live checkpoint swap
# Any other GET answers the health payload (the probe path).

REPLICA_PATHS = (METRICS, SPANS, GENERATE, GENERATE_STREAM, GENERATE_TEXT,
                 PREFILL_EXPORT, KV_IMPORT, PREFIX_EXPORT, WEIGHTS_SWAP,
                 PROFILE, LOGS)
