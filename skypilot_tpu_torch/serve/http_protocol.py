"""HTTP routes and headers of the port's replica front (copied from
`skypilot_tpu/serve/http_protocol.py`; the other routes of the
reference come with later slices)."""
from __future__ import annotations

REQUEST_ID_HEADER = 'X-SkyTPU-Request-Id'
DEADLINE_HEADER = 'X-SkyTPU-Deadline-Ms'

HEALTH = '/health'                    # GET: health/readiness payload
GENERATE = '/generate'                # POST: batch token generation
# Any other GET answers the health payload (the probe path).
