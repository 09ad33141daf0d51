"""Feature caches for host-resident features: rankings (policy, presample),
the static cache (manager) and the dynamic previous-batch cache (dynamic)."""
