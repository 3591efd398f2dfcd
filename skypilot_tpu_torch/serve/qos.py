"""QoS priority classes of the replica (copied from the replica's half
of `skypilot_tpu/serve/qos.py`).

Two classes, ``interactive`` (chat: small token budgets, tight
deadlines) and ``batch`` (offline inference: big budgets, loose
deadlines), ride every request as the ``X-SkyTPU-QoS-Class`` header
(serve/http_protocol.py).  The engine's admission queue clamps each
request's ``max_new_tokens`` to its class budget, applies the class
deadline default when the request carries none, and pops queued work in
smooth-weighted class order (serve/scheduler.py).

Config precedence: the service spec's ``routers: {qos: {...}}`` block
(exported to replicas as ``SKYTPU_QOS_SPEC``) over the env defaults
(``SKYTPU_LB_QOS_WEIGHTS``, ``SKYTPU_QOS_DEFAULT_CLASS``) over the
built-ins.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

CLASSES = ('interactive', 'batch')
INTERACTIVE = 'interactive'
BATCH = 'batch'

_DEFAULT_WEIGHTS = {INTERACTIVE: 4, BATCH: 1}


def default_class() -> str:
    """Class assumed when a request carries no QoS header."""
    value = os.environ.get('SKYTPU_QOS_DEFAULT_CLASS', INTERACTIVE)
    return value if value in CLASSES else INTERACTIVE


def normalize(value: Optional[str]) -> str:
    """Clamp an arbitrary header value to a known class."""
    if value:
        value = value.strip().lower()
        if value in CLASSES:
            return value
    return default_class()


@dataclasses.dataclass
class QosClassSpec:
    """Per-class policy knobs."""
    weight: int = 1                       # admission share
    max_new_tokens: Optional[int] = None  # token budget (clamp)
    deadline_ms: Optional[float] = None   # deadline default

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {'weight': self.weight}
        if self.max_new_tokens is not None:
            out['max_new_tokens'] = self.max_new_tokens
        if self.deadline_ms is not None:
            out['deadline_ms'] = self.deadline_ms
        return out


def _env_weights() -> Dict[str, int]:
    """SKYTPU_LB_QOS_WEIGHTS, e.g. 'interactive=4,batch=1'."""
    raw = os.environ.get('SKYTPU_LB_QOS_WEIGHTS', '')
    weights = dict(_DEFAULT_WEIGHTS)
    for part in raw.split(','):
        name, _, value = part.partition('=')
        name = name.strip().lower()
        if name in CLASSES:
            try:
                weights[name] = max(1, int(value))
            except ValueError:
                pass
    return weights


def from_config(config: Optional[Dict[str, Any]]
                ) -> Dict[str, QosClassSpec]:
    """Class specs from a ``routers.qos`` block (validated by
    `validate_config`); env/built-in defaults per class otherwise."""
    weights = _env_weights()
    specs = {name: QosClassSpec(weight=weights[name])
             for name in CLASSES}
    for name, cfg in (config or {}).items():
        if name not in CLASSES or not isinstance(cfg, dict):
            continue
        spec = specs[name]
        if cfg.get('weight') is not None:
            spec.weight = max(1, int(cfg['weight']))
        if cfg.get('max_new_tokens') is not None:
            spec.max_new_tokens = int(cfg['max_new_tokens'])
        if cfg.get('deadline_ms') is not None:
            spec.deadline_ms = float(cfg['deadline_ms'])
    return specs


# engine_config is on the per-request path; cached by the raw env
# strings, so a changed env invalidates and the steady state parses once.
_ENGINE_CACHE: Dict[Any, Dict[str, QosClassSpec]] = {}


def engine_config() -> Dict[str, QosClassSpec]:
    """Class specs for the engine scheduler, from SKYTPU_QOS_SPEC (the
    spec's ``routers.qos`` block as JSON)."""
    cache_key = (os.environ.get('SKYTPU_QOS_SPEC'),
                 os.environ.get('SKYTPU_LB_QOS_WEIGHTS'))
    cached = _ENGINE_CACHE.get(cache_key)
    if cached is not None:
        return cached
    raw = cache_key[0]
    config = None
    if raw:
        try:
            config = json.loads(raw)
        except json.JSONDecodeError:
            config = None
    specs = from_config(config if isinstance(config, dict) else None)
    _ENGINE_CACHE.clear()
    _ENGINE_CACHE[cache_key] = specs
    return specs


def validate_config(config: Any, where: str) -> None:
    """Validation of a ``qos:`` block; raises ValueError."""
    if config is None:
        return
    if not isinstance(config, dict):
        raise ValueError(f'{where}: expected a mapping of QoS classes, '
                         f'got {type(config).__name__}')
    for name, cfg in config.items():
        if name not in CLASSES:
            raise ValueError(f'{where}: unknown QoS class {name!r}; '
                             f'one of {CLASSES}')
        if not isinstance(cfg, dict):
            raise ValueError(f'{where}.{name}: expected a mapping')
        for key in cfg:
            if key not in ('weight', 'max_new_tokens', 'deadline_ms'):
                raise ValueError(
                    f'{where}.{name}: unknown key {key!r}; one of '
                    f"('weight', 'max_new_tokens', 'deadline_ms')")
        if cfg.get('weight') is not None and int(cfg['weight']) < 1:
            raise ValueError(f'{where}.{name}.weight must be >= 1')
        if (cfg.get('max_new_tokens') is not None and
                int(cfg['max_new_tokens']) < 1):
            raise ValueError(
                f'{where}.{name}.max_new_tokens must be >= 1')
        if (cfg.get('deadline_ms') is not None and
                float(cfg['deadline_ms']) <= 0):
            raise ValueError(f'{where}.{name}.deadline_ms must be > 0')
