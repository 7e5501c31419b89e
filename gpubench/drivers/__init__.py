"""The loops a traffic mix drives: ``<driver>.py`` per ``driver`` name.

Each module defines ``Driver(cluster, store, plugin, params, seed,
seconds)`` with ``warm()``, ``step() -> units``, ``release()``,
``check() -> {name: {"value", "limit"}}``, ``end_to_end(units,
elapsed_s)``, ``least_s(card)`` and the attributes ``calls`` and
``failed``.
"""
