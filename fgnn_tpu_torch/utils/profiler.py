"""Step/epoch/init profiler (port of ``fgnn_tpu/utils/profiler.py``).

The source system's Profiler singleton (samgraph/common/profiler.{h,cc}):
three metric families (init / step / epoch) at detail levels L1/L2/L3, gated
by ``FGNN_TPU_PROFILE_LEVEL``, written by the engines' stages and read back
by the apps for their ``test_result:`` lines (profiler.h:30-131). Item and
lane names are the reference's, kept verbatim; values live in plain dicts
keyed by ``epoch * num_step + step``.

Two things differ from the reference, neither in what it reports:

* Node access (``FGNN_TPU_LOG_NODE_ACCESS``) counts in a NumPy array, one
  ``bincount`` a batch, where the reference updates a ``Counter`` one Python
  int at a time. Each node keeps the index of its first access, and the
  ranking orders by (count descending, first access), which is the order of
  ``Counter.most_common``: ``report_node_access`` writes the same bytes.
* While a trace is on (``FGNN_TPU_DUMP_TRACE``), :meth:`Profiler.span`
  also opens a ``torch.profiler.record_function`` range named after the
  lane, so a torch.profiler trace of the run shows the reference's lanes.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from .. import constants
from ..config import env_int

# Step items (profiler.h:59-117). L1 = headline, L2 = per-stage, L3 = per-kernel.
#
# Reference item names whose kernel pipelines are single fused XLA ops here
# carry no separate timer and are intentionally absent from this list:
#   kLogL2CacheCopyIndexTime / kLogL2CacheCopyMissTime — the index ships
#     inside the same program as the split (no separate copy stage);
#   kLogL2CacheCombineCacheTime — `FeatureCache.combine` merges hit-scatter
#     and miss-scatter in ONE op, timed as L2_cache_combine_miss_time;
#   kLogL3KHopSampleSortCooTime/CountEdgeTime/CompactEdgeTime — the
#     count/scan/compact pipeline is replaced by masked static-shape
#     padding (no compaction pass exists);
#   kLogL3RemapPopulateTime — hashtable populate+unique is one sort
#     (L3_remap_unique_time);
#   kLogL3CacheGetIndexStep1-3 — the 3-kernel miss-index pipeline is one
#     sort-partition program (L2_cache_get_index_time).
STEP_ITEMS = [
    # L1 — written by every engine (run_epoch / wave loops)
    "L1_num_node", "L1_num_sample", "L1_sample_time", "L1_copy_time",
    "L1_convert_time", "L1_train_time", "L1_feature_bytes", "L1_label_bytes",
    "L1_id_bytes", "L1_graph_bytes", "L1_miss_nbytes", "L1_remote_nbytes",
    "L1_prefetch_advanced", "L1_get_neighbour_time", "L1_send_time",
    "L1_recv_time",
    # L2 — written by the stepwise path at profile_level >= 2 (engine.py)
    # and the factored wave loop (parallel/factored.py)
    "L2_shuffle_time", "L2_core_sample_time", "L2_id_remap_time",
    "L2_graph_copy_time", "L2_id_copy_time", "L2_extract_time",
    "L2_feat_copy_time", "L2_cache_get_index_time",
    "L2_cache_extract_miss_time", "L2_cache_combine_miss_time",
    # L3 — written by the de-fused measurement pass at profile_level >= 3
    # (OneChipEngine._profile_l3)
    "L3_khop_sample_coo_time", "L3_remap_unique_time",
    "L3_remap_map_edge_time",
]

EPOCH_ITEMS = [
    "epoch_total_time", "epoch_sample_time", "epoch_shuffle_time",
    "epoch_core_sample_time", "epoch_id_remap_time", "epoch_copy_time",
    "epoch_convert_time", "epoch_extract_time", "epoch_train_time",
    "epoch_feature_bytes", "epoch_miss_bytes", "epoch_cap_overflow",
]

INIT_ITEMS = [
    "init_load_dataset", "init_copy", "init_presample", "init_build_cache",
    "init_compile", "init_other",
]

# The reference's 19 typed step-trace lanes (TRACE_TYPES macro,
# profiler.h:142-176), names kept verbatim so a reference timeline
# consumer sees the same lanes. Where this design fuses two reference
# kernel pipelines into one XLA program the span is emitted on the FIRST
# lane of the pair and the second lane is structurally empty:
#   kL3Event_Copy_CacheCopy_CombineMiss carries the fused miss+cache
#     combine (FeatureCache.combine is ONE gather program — the
#     CombineCache scatter does not exist separately);
#   kL3Event_Copy_CacheCopy_CopyIndex is empty on single-chip archs (the
#     index never leaves the device); in arch5 the index rides the wave
#     transfer emitted on kL2Event_Copy_Graph.
TRACE_ITEMS = [
    "kL0Event_Train_Step",
    "kL1Event_Sample",
    "kL2Event_Sample_Shuffle",
    "kL2Event_Sample_Core",
    "kL2Event_Sample_IdRemap",
    "kL1Event_Copy",
    "kL2Event_Copy_Id",
    "kL2Event_Copy_Graph",
    "kL2Event_Copy_Extract",
    "kL2Event_Copy_FeatCopy",
    "kL2Event_Copy_CacheCopy",
    "kL3Event_Copy_CacheCopy_GetIndex",
    "kL3Event_Copy_CacheCopy_CopyIndex",
    "kL3Event_Copy_CacheCopy_ExtractMiss",
    "kL3Event_Copy_CacheCopy_CopyMiss",
    "kL3Event_Copy_CacheCopy_CombineMiss",
    "kL3Event_Copy_CacheCopy_CombineCache",
    "kL1Event_Convert",
    "kL1Event_Train",
]


class Profiler:
    """Per-process profiler. ``Profiler.get()`` mirrors Profiler::Get()."""

    _instance: Optional["Profiler"] = None

    def __init__(self, level: Optional[int] = None):
        self.level = (
            level
            if level is not None
            else env_int(constants.ENV_PROFILE_LEVEL, 1)
        )
        self._step: Dict[str, Dict[int, float]] = collections.defaultdict(dict)
        self._epoch: Dict[str, Dict[int, float]] = collections.defaultdict(dict)
        self._init: Dict[str, float] = {}
        self._trace: List[dict] = []
        self._num_step = 1
        self.log_node_access = bool(
            os.environ.get(constants.ENV_LOG_NODE_ACCESS)
        )
        # node access: counts and first-access order by node id, and the
        # touched-node mask of each epoch (grown to the largest id seen)
        self._access = np.zeros(0, dtype=np.int64)
        self._first = np.zeros(0, dtype=np.int64)
        self._num_seen = 0
        self._access_epochs: List[np.ndarray] = []

    # -- singleton ---------------------------------------------------------
    @classmethod
    def get(cls) -> "Profiler":
        if cls._instance is None:
            cls._instance = Profiler()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None

    # -- config ------------------------------------------------------------
    def set_num_step(self, num_step: int) -> None:
        self._num_step = max(1, num_step)

    @property
    def num_step(self) -> int:
        return self._num_step

    def step_key(self, epoch: int, step: int) -> int:
        return epoch * self._num_step + step

    # -- public readers (keep examples off the private dicts) -------------
    def has_step_item(self, item: str) -> bool:
        return bool(self._step.get(item))

    def get_init_value(self, item: str) -> float:
        return self._init.get(item, 0.0)

    # -- writers (LogStep / LogStepAdd / LogEpochAdd analogs) -------------
    def _lvl(self, item: str) -> int:
        if item.startswith("L1") or item.startswith("epoch") or item.startswith("init"):
            return 1
        if item.startswith("L2"):
            return 2
        return 3

    def log_step(self, key: int, item: str, value: float) -> None:
        if self._lvl(item) <= self.level:
            self._step[item][key] = value

    def log_step_add(self, key: int, item: str, value: float) -> None:
        if self._lvl(item) <= self.level:
            self._step[item][key] = self._step[item].get(key, 0.0) + value

    def log_epoch_add(self, epoch: int, item: str, value: float) -> None:
        self._epoch[item][epoch] = self._epoch[item].get(epoch, 0.0) + value

    def log_init(self, item: str, value: float) -> None:
        self._init[item] = self._init.get(item, 0.0) + value

    # -- node access (LogNodeAccess / ReportNodeAccess analog) -------------
    def _grow(self, size: int) -> None:
        if size <= self._access.shape[0]:
            return
        size = max(size, 2 * self._access.shape[0])
        pad = size - self._access.shape[0]
        self._access = np.concatenate([self._access,
                                       np.zeros(pad, np.int64)])
        self._first = np.concatenate([self._first,
                                      np.full(pad, -1, np.int64)])
        self._access_epochs = [np.concatenate([m, np.zeros(pad, bool)])
                               for m in self._access_epochs]

    def log_node_access_batch(self, node_ids) -> None:
        """Count one batch's accesses (ids < 0 are padding)."""
        if not self.log_node_access:
            return
        ids = np.asarray(node_ids).reshape(-1)
        ids = ids[ids >= 0].astype(np.int64)
        if not ids.size:
            return
        self._grow(int(ids.max()) + 1)
        fresh = ids[self._first[ids] < 0]
        if fresh.size:
            # the new ids in the order of their first access in the batch
            new, first_pos = np.unique(fresh, return_index=True)
            new = new[np.argsort(first_pos, kind="stable")]
            self._first[new] = self._num_seen + np.arange(new.size)
            self._num_seen += new.size
        self._access += np.bincount(ids, minlength=self._access.shape[0])
        if self._access_epochs:
            self._access_epochs[-1][ids] = True

    def begin_node_access_epoch(self) -> None:
        if self.log_node_access:
            self._access_epochs.append(np.zeros(self._access.shape[0], bool))

    def node_access_frequency(self) -> np.ndarray:
        """Accesses by node id (the reference returns a ``Counter``)."""
        return self._access

    def node_access_ranking(self) -> np.ndarray:
        """The touched nodes, most accessed first, ties by first access:
        ``Counter.most_common``'s order."""
        touched = np.nonzero(self._access)[0]
        order = np.lexsort((self._first[touched], -self._access[touched]))
        return touched[order]

    def node_access_similarity(self) -> List[float]:
        """Jaccard-style similarity of touched-node sets across epochs
        (ReportNodeAccess, profiler.cc:657-791)."""
        sims = []
        eps = self._access_epochs
        for a, b in zip(eps, eps[1:]):
            na, nb = int(a.sum()), int(b.sum())
            if not na or not nb:
                sims.append(0.0)
            else:
                sims.append(int((a & b).sum()) / max(1, int((a | b).sum())))
        return sims

    def optimal_cache_hit_curve(self, num_nodes: int, points: int = 101):
        """Optimal-policy hit rate vs cache-percentage curve
        (ReportNodeAccessSimple, profiler.cc:793-860)."""
        total = int(self._access.sum())
        if total == 0:
            return [(i / (points - 1), 0.0) for i in range(points)]
        freqs = np.sort(self._access[self._access > 0])[::-1]
        cum = np.cumsum(freqs)
        curve = []
        for i in range(points):
            pct = i / (points - 1)
            k = int(pct * num_nodes)
            hit = int(cum[min(k, len(cum)) - 1]) / total if k > 0 else 0.0
            curve.append((pct, hit))
        return curve

    def report_node_access(self, path_prefix: str, num_nodes: int) -> None:
        """Write node-access artifacts (ReportNodeAccess +
        ReportNodeAccessSimple, profiler.cc:657-860): frequency-ranked
        binary node list (cache-ranking file format), epoch-set similarity,
        and the optimal-cache-hit curve."""
        self.node_access_ranking().astype(np.uint32).tofile(
            path_prefix + "_ranking.bin"
        )
        report = {
            "num_touched": int(np.count_nonzero(self._access)),
            "total_accesses": int(self._access.sum()),
            "epoch_similarity": self.node_access_similarity(),
            "optimal_hit_curve": self.optimal_cache_hit_curve(num_nodes, 21),
        }
        with open(path_prefix + "_access.json", "w") as f:
            json.dump(report, f, indent=2)

    # -- trace (TraceStepBegin/End analog, profiler.h:142-176) ------------
    def trace_event(self, key: int, item: str, begin_us: float, end_us: float) -> None:
        self._trace.append(
            {"key": key, "name": item, "ts": begin_us, "dur": end_us - begin_us}
        )

    @property
    def trace_enabled(self) -> bool:
        return bool(os.environ.get(constants.ENV_DUMP_TRACE))

    @contextlib.contextmanager
    def trace_scope(self, key: int, item: str):
        """Context manager emitting one TraceStepBegin/End pair, inside a
        ``torch.profiler.record_function(item)`` range while a trace is
        on."""
        ranged = contextlib.nullcontext()
        if self.trace_enabled:
            import torch

            ranged = torch.profiler.record_function(item)
        with ranged:
            t0 = time.monotonic() * 1e6
            try:
                yield
            finally:
                self.trace_event(key, item, t0, time.monotonic() * 1e6)

    def span(self, key: int, item: str):
        """:meth:`trace_scope` while a trace is on, else nothing: the lane
        of one engine stage."""
        if self.trace_enabled:
            return self.trace_scope(key, item)
        return contextlib.nullcontext()

    def dump_trace(self, path: str) -> None:
        """Chrome trace-event JSON (samgraph_dump_trace analog).

        Each of the 19 reference lanes (TRACE_ITEMS) gets its own named
        thread row; names outside the taxonomy (wave-level events from the
        factored engines) get rows after them."""
        lanes = list(TRACE_ITEMS)
        for e in self._trace:
            if e["name"] not in lanes:
                lanes.append(e["name"])
        tid = {name: i for i, name in enumerate(lanes)}
        # thread_name metadata makes the lanes named in chrome://tracing
        events = [
            {
                "name": "thread_name", "ph": "M", "pid": 0, "tid": i,
                "args": {"name": name},
            }
            for name, i in tid.items()
        ]
        events += [
            {
                "name": e["name"], "ph": "X", "ts": e["ts"], "dur": e["dur"],
                "pid": 0, "tid": tid[e["name"]], "args": {"key": e["key"]},
            }
            for e in self._trace
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    def lane_summary(self) -> Dict[str, dict]:
        """Per-lane event count / total seconds — the fig-timeline table."""
        out: Dict[str, dict] = {}
        for e in self._trace:
            s = out.setdefault(e["name"], {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] += e["dur"] / 1e6
        return out

    # -- readers -----------------------------------------------------------
    def get_step_value(self, key: int, item: str) -> float:
        return self._step[item].get(key, 0.0)

    def get_epoch_value(self, epoch: int, item: str) -> float:
        return self._epoch[item].get(epoch, 0.0)

    def step_average(self, item: str, skip_first_epoch: bool = True) -> float:
        vals = self._step[item]
        if not vals:
            return 0.0
        items = [
            v for k, v in vals.items() if not (skip_first_epoch and k < self._num_step)
        ]
        if not items:
            items = list(vals.values())
        return sum(items) / len(items)

    def epoch_average(self, item: str, skip_first_epoch: bool = True) -> float:
        vals = self._epoch[item]
        if not vals:
            return 0.0
        items = [v for e, v in vals.items() if not (skip_first_epoch and e == 0)]
        if not items:
            items = list(vals.values())
        return sum(items) / len(items)

    # -- reports (report_step_average / report_init analogs) ---------------
    def report_step_average(self, epoch: int, step: int) -> str:
        parts = []
        for item in ("L1_sample_time", "L1_copy_time", "L1_train_time"):
            parts.append(f"{item}={self.step_average(item):.6f}")
        return " | ".join(parts)

    def report_init(self) -> str:
        return " | ".join(f"{k}={v:.4f}" for k, v in self._init.items())
