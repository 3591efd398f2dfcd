"""Replica roles: the one home for role names and the missing-role
default (copied from `skypilot_tpu/serve/roles.py`).

A record without a role means *mixed* everywhere; a typo raises instead
of landing a replica in the wrong pool.  A leaf module: it imports
nothing of the package.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

ROLES = ('prefill', 'decode', 'mixed')
DEFAULT_ROLE = 'mixed'

# Launch-time prefill share per static role (scheduler.RoleBudget
# derives per-tick budgets from these; 0.5 = unclamped mixed).
DEFAULT_SPLITS = {'prefill': 1.0, 'decode': 0.0, 'mixed': 0.5}


def normalize(role: Optional[str]) -> str:
    """A possibly-missing role value -> a valid role name (None/'' ->
    the mixed default).  Unknown names raise."""
    if not role:
        return DEFAULT_ROLE
    if role not in ROLES:
        raise ValueError(f'Unknown replica role {role!r}; '
                         f'one of {ROLES}')
    return role


def role_of(record: Mapping[str, Any]) -> str:
    """The role of a replica record/info dict, missing or empty values
    read as 'mixed'."""
    return normalize(record.get('role'))
