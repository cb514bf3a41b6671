"""Field value ranges derived from the bound cfg constants.

A copy of ``derive_ranges_from`` in ``tpuvsr/analysis/passes/widths.py``
(interval ranges of the protocol quantities, from the constants alone).
It is the one source of the packed frontier's per-plane bit budgets
(``engine/pack.py``), so the port packs states exactly as the JAX
package does, with one exception: the recovery nonce of a module with
``RetryRecovery`` (``NONCE_UNBOUNDED``).  The JAX pass bounds the nonce
by 1 + CrashLimit ("UniqueNumber mints one per crash",
``tpuvsr/analysis/passes/widths.py:23``), but RetryRecovery mints one
too, as often as it fires, so no bound is derivable there and the port
derives none: the planes that hold the nonce keep raw 32-bit lanes.
"""

from __future__ import annotations

# modules whose RetryRecovery re-mints the recovery nonce without bound
# (VR_REPLICA_RECOVERY.tla:951-983)
NONCE_UNBOUNDED = frozenset({"VR_REPLICA_RECOVERY"})


def derive_ranges_from(constants, module_name):
    """Interval ranges of the protocol quantities, from a bare constants
    dict and module name.  Returns entries only for derivable
    quantities."""
    c = constants
    rng = {}

    def geti(name, default=None):
        v = c.get(name, default)
        return v if isinstance(v, int) and not isinstance(v, bool) \
            else None

    timer = geti("StartViewOnTimerLimit")
    restarts = geti("RestartEmptyLimit", 0)
    crashes = geti("CrashLimit", 0)
    values = c.get("Values")
    nvalues = len(values) if isinstance(values, frozenset) else None
    clients = geti("ClientCount", 1)
    replicas = geti("ReplicaCount")

    if timer is not None:
        extra = restarts or 0
        if module_name != "VSR":
            extra = 0          # only VSR's RestartEmpty re-mints views
        rng["view_number"] = (0, 1 + timer + extra)
    if nvalues is not None:
        rng["operation"] = (0, nvalues)
        rng["op_number"] = (0, nvalues)        # MAX_OPS = |Values|
        rng["commit_number"] = (0, nvalues)
        rng["request_number"] = (0, nvalues)
        rng["cp_number"] = (0, nvalues)
        rng["entry_code"] = (0, nvalues + 1)
    if clients is not None:
        rng["client_id"] = (0, clients)
    if replicas is not None:
        rng["replica_id"] = (0, replicas)
    if crashes is not None and module_name not in NONCE_UNBOUNDED:
        rng["recovery_nonce"] = (0, 1 + crashes)
    return rng
