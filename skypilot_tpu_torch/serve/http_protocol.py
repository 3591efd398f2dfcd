"""HTTP routes and headers of the port's replica front (copied from
`skypilot_tpu/serve/http_protocol.py`: its headers and its "replica
front" block; both fronts, serve/model_server.py threaded and
serve/async_server.py asyncio, answer the same routes)."""
from __future__ import annotations

# Propagated load balancer -> replica -> engine slot; echoed on every
# response.
REQUEST_ID_HEADER = 'X-SkyTPU-Request-Id'
# Routing facts the LB forwards (stamped into the request's span): the
# role pool that served it, whether prefix affinity hit, how long the
# KV handoff took, and which delivery attempt this is (0 = first try,
# 1 = the one-shot same-role retry).
ROUTED_ROLE_HEADER = 'X-SkyTPU-Routed-Role'
AFFINITY_HEADER = 'X-SkyTPU-Affinity'
HANDOFF_MS_HEADER = 'X-SkyTPU-Handoff-Ms'
ATTEMPT_HEADER = 'X-SkyTPU-Attempt'
# Per-request time budget in milliseconds (504 past it).
DEADLINE_HEADER = 'X-SkyTPU-Deadline-Ms'
# QoS priority class ('interactive' | 'batch', serve/qos.py).
QOS_CLASS_HEADER = 'X-SkyTPU-QoS-Class'

HEADERS = (REQUEST_ID_HEADER, ROUTED_ROLE_HEADER, AFFINITY_HEADER,
           HANDOFF_MS_HEADER, ATTEMPT_HEADER, DEADLINE_HEADER,
           QOS_CLASS_HEADER)

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
DRAIN = '/drain'                      # POST: controller retirement path
PREFIX_EXPORT = '/prefix_export'      # POST: drain-time sibling handoff
ROLE_BUDGET = '/role_budget'          # POST: rebalance push / role morph
WEIGHTS_SWAP = '/weights_swap'        # POST: live checkpoint swap
# Any other GET answers the health payload (the probe path).

REPLICA_PATHS = (METRICS, SPANS, GENERATE, GENERATE_STREAM, GENERATE_TEXT,
                 PREFILL_EXPORT, KV_IMPORT, DRAIN, PREFIX_EXPORT,
                 ROLE_BUDGET, WEIGHTS_SWAP, PROFILE, LOGS)
