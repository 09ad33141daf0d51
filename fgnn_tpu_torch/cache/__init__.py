"""Feature caches for host-resident features: rankings (policy, presample),
the static cache (manager) and the dynamic previous-batch cache (dynamic)."""
from .manager import FeatureCache
from .policy import build_ranking
from .presample import presample_ranking
