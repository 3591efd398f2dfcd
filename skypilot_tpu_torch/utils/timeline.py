"""Chrome trace-event timeline: the request-span half of
`skypilot_tpu/utils/timeline.py`, copied.

Recording is on when SKYTPU_TIMELINE_FILE is set (read at every check,
so a path set after import still counts) or after `start(path)`; the
events are dumped as Chrome trace-event JSON at exit.  The serving
request spans (observability/tracing.py) emit their finished phases here
through `add_complete_event`, so one chrome://tracing load shows every
request's queue/prefill/decode bars, and the flight recorder's
`ControlSpan`s (observability/events.py) theirs under cat 'control'.
`write_trace` writes a standalone trace (the journal's Chrome export).
The reference's control-plane spans (`Event`, `@event`, FileLock spans)
have no caller in the port and are not copied.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
from typing import List, Optional

_events: List[dict] = []
_events_lock = threading.Lock()
_enabled_path: Optional[str] = None
_atexit_registered = False


def _register_atexit_once() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(save_timeline)


def start(path: str) -> None:
    """Enable recording to `path` (programmatic alternative to setting
    SKYTPU_TIMELINE_FILE); registers the atexit dump exactly once."""
    global _enabled_path
    _enabled_path = path
    _register_atexit_once()


def enabled() -> bool:
    return _active_path() is not None


def _active_path() -> Optional[str]:
    """The dump path, honoring an env var set after import."""
    if _enabled_path is not None:
        return _enabled_path
    return os.environ.get('SKYTPU_TIMELINE_FILE')


def add_complete_event(name: str, start_s: float, duration_s: float,
                       args: Optional[dict] = None,
                       cat: str = 'request') -> None:
    """Record an already-finished span ('X' complete event): `start_s`
    is wall-clock seconds (time.time()), `duration_s` its length.  Used
    by observability/tracing.py, whose phases are only known in
    retrospect (queue wait ends when the engine admits the request)."""
    path = _active_path()
    if path is None:
        return
    _register_atexit_once()
    evt = {
        'name': name,
        'cat': cat,
        'ph': 'X',
        'ts': int(start_s * 10**6),
        'dur': max(0, int(duration_s * 10**6)),
        'pid': os.getpid(),
        'tid': threading.get_ident(),
    }
    if args:
        evt['args'] = args
    with _events_lock:
        _events.append(evt)


def write_trace(path: str, trace_events: List[dict]) -> None:
    """Write a list of Chrome trace events as a standalone trace file
    (the journal export of observability/events.py), apart from the
    live-recording buffer above."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w', encoding='utf-8') as f:
        json.dump({'traceEvents': list(trace_events)}, f)


def save_timeline() -> None:
    # Re-check the env var: a path set after import must still produce
    # a dump.
    path = _active_path()
    if path is None or not _events:
        return
    with _events_lock:
        payload = {'traceEvents': list(_events)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(payload, f)
