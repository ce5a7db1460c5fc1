"""Canonical service metric names (the reference's
``scaling/autoscaler.py`` constants; its policies are not ported yet).

The serving engine publishes these into the shared ``MetricsRegistry``
and the request router reads ``kv_free_pages`` for KV-aware routing."""

M_REQUESTS = "requests_total"
M_COMPLETIONS = "completions_total"
M_SLO_VIOLATIONS = "slo_violations_total"
M_QUEUE_DEPTH = "queue_depth"
M_UTILIZATION = "utilization"
# per-engine KV-pool occupancy (pages in use / pool) and free pages
M_KV_PAGES = "kv_pages_in_use_ratio"
M_KV_FREE_PAGES = "kv_free_pages"
M_PREEMPTIONS = "engine_oom_preemptions_total"
