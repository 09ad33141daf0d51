"""Static-shape planning (port of ``fgnn_tpu/ops/padding.py``).

Pure Python: :func:`make_plan` computes the padded per-hop caps and the
degree-tier layout of the last hop from the calibrated counts, exactly as
the reference does, so both frameworks size every batch alike. The
reference's environment overrides (``FGNN_TPU_ALLOC_SCALE``,
``FGNN_TPU_CAP_BUCKET``, the latter a shape bucketing for remote TPU
compiles) are not carried over.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

from .. import constants


def _round_up(x: int, m: int = 128) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """Per-layer static buffer sizes for one mini-batch sample.

    Layer order is sampling order: layer 0 seeds are the training batch,
    hop l uses ``fanouts[l]``. ``tier_layout`` is the degree-tiered last
    hop: ``((vertex_cap, slot_width), ...)`` with descending widths, caps
    summing to the frontier cap (see ``ops.sampling._tiered_last_hop``).
    """

    batch_size: int
    fanouts: Tuple[int, ...]           # in sampling order (seed hop first)
    num_input_cap: Tuple[int, ...]     # cap on input (seed) count per hop
    num_edge_cap: Tuple[int, ...]      # cap on sampled edges per hop
    num_unique_cap: Tuple[int, ...]    # cap on unique output per hop
    tier_layout: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def tier_a_cap(self) -> Optional[int]:
        return self.tier_layout[0][0] if self.tier_layout else None

    @property
    def tier_b_fanout(self) -> Optional[int]:
        return self.tier_layout[-1][1] if self.tier_layout else None

    @property
    def num_layer(self) -> int:
        return len(self.fanouts)

    @property
    def final_input_cap(self) -> int:
        """Cap on a dedup batch's ``input_nodes`` (the feature-gather size)."""
        return self.num_unique_cap[-1]


def make_plan(
    batch_size: int,
    fanouts: Sequence[int],
    num_node: int,
    scale: float = constants.ALLOC_SCALE,
    unique_caps: Optional[Sequence] = None,
    tier_stats: Optional[dict] = None,
) -> SamplePlan:
    """Compute padded sizes.

    ``fanouts`` is given in config order (deepest hop first) and reversed
    into sampling order here. ``unique_caps`` optionally overrides the
    worst-case per-hop unique caps with measured ``(cumulative, new)``
    pairs (or legacy cumulative ints), in sampling order. ``tier_stats``
    (``{t: [per-probe count(frontier deg > t)]}``) enables the tier search.
    """
    fan = tuple(reversed([int(f) for f in fanouts]))
    n_in = []
    n_edge = []
    n_uniq = []
    cur = _round_up(batch_size)
    for l, f in enumerate(fan):
        n_in.append(cur)
        edges = cur * f
        n_edge.append(edges)
        # unique layout is [static seed block | appended new nodes]: the
        # cap covers the seed slots plus the measured/worst-case appends
        if unique_caps is not None:
            uc = unique_caps[l]
            if isinstance(uc, tuple):
                _, new = uc
                uniq = cur + _round_up(int(new * scale))
            else:
                uniq = max(_round_up(int(uc * scale)), cur + 128)
        else:
            uniq = _round_up(cur + edges)      # worst case: all new
        # at most num_node NEW nodes can ever be appended
        uniq = min(uniq, _round_up(cur + num_node))
        n_uniq.append(uniq)
        cur = uniq

    # degree-tiered last hop: search threshold subsets (up to 3 take-all
    # tiers below the Floyd tier) minimising total slots, each tier-prefix
    # cap margined with max-plus-range and scale; engage only when it
    # saves >= 10% of the flat cap
    tier_layout = None
    if tier_stats:
        V, f_last = n_in[-1], fan[-1]

        def prefix_cap(counts):
            hi, lo = max(counts), min(counts)
            return min(_round_up(int((hi + (hi - lo)) * scale)), V)

        cands = sorted(t for t, c in tier_stats.items() if t < f_last and c)
        best = None
        for k in (1, 2, 3):
            for combo in itertools.combinations(cands, k):
                ths = sorted(combo, reverse=True)   # descending widths
                pref = []
                for t in ths:
                    p = prefix_cap(tier_stats[t])
                    if pref and p < pref[-1]:
                        p = pref[-1]
                    pref.append(p)
                if pref[-1] >= V:
                    continue
                caps = [pref[0]] + [
                    pref[i] - pref[i - 1] for i in range(1, len(pref))
                ] + [V - pref[-1]]
                widths = [f_last] + list(ths)
                slots = sum(c * w for c, w in zip(caps, widths))
                if best is None or slots < best[0]:
                    best = (slots, tuple(zip(caps, widths)))
        if best is not None and best[0] < 0.9 * n_edge[-1]:
            n_edge[-1] = best[0]
            tier_layout = best[1]

    return SamplePlan(
        batch_size=batch_size,
        fanouts=fan,
        num_input_cap=tuple(n_in),
        num_edge_cap=tuple(n_edge),
        num_unique_cap=tuple(n_uniq),
        tier_layout=tier_layout,
    )
