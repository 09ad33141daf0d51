"""Dataset schema (the port's copy of ``fgnn_tpu/data/schema.py``).

``struct Dataset`` of the source system (common.h:157-184): a CSR graph with
features, labels and splits, plus optional weighted-sampling tables. The
arrays are NumPy, possibly mmap-backed and read-only; the engine decides
what goes to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Dataset:
    name: str
    num_node: int
    num_edge: int
    num_class: int

    # graph topology: CSR over int32 ids, -1 is the padding sentinel
    indptr: np.ndarray       # [num_node + 1] int
    indices: np.ndarray      # [num_edge] int32

    # features / labels
    feat: np.ndarray         # [num_node, feat_dim] float32 (mmap ok)
    label: np.ndarray        # [num_node] int

    # splits
    train_set: np.ndarray    # int32 node ids
    test_set: np.ndarray
    valid_set: np.ndarray

    # weighted-sampling tables (optional; common.h:170-174)
    prob_table: Optional[np.ndarray] = None          # [num_edge] f32
    alias_table: Optional[np.ndarray] = None         # [num_edge] i32
    prob_prefix_table: Optional[np.ndarray] = None   # [num_edge] f32

    # degrees + cache rankings (optional)
    in_degrees: Optional[np.ndarray] = None
    out_degrees: Optional[np.ndarray] = None
    ranking_nodes: Optional[np.ndarray] = None

    # empty-feat mode (SAMGRAPH_EMPTY_FEAT analog, engine.cc:138-155):
    # ``feat`` is a small fake table indexed modulo its row count. Set
    # EXPLICITLY: a feature matrix with fewer rows than the graph is
    # otherwise a corrupt dataset, not a mock (validate() rejects it).
    empty_feat: bool = False

    @property
    def feat_dim(self) -> int:
        return int(self.feat.shape[1])

    @property
    def feat_mod(self) -> int:
        """Modulo for empty-feat mock gathers (0 = real features)."""
        return int(self.feat.shape[0]) if self.empty_feat else 0

    def degrees(self) -> np.ndarray:
        """Out-degree from indptr (the sampling-relevant degree)."""
        if self.out_degrees is not None:
            return self.out_degrees
        return np.diff(self.indptr).astype(np.int32)

    def validate(self) -> None:
        """Raises ``ValueError`` on a malformed dataset."""
        checks = [
            (self.indptr.shape[0] == self.num_node + 1,
             "indptr has num_node + 1 entries"),
            (self.indices.shape[0] == self.num_edge,
             "indices has num_edge entries"),
            (int(self.indptr[0]) == 0, "indptr starts at 0"),
            (int(self.indptr[-1]) == self.num_edge, "indptr ends at num_edge"),
            (not self.num_edge or int(self.indices.max()) < self.num_node,
             "every neighbour id is below num_node"),
            (self.feat.shape[0] > 0, "the feature table has rows"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"invalid dataset {self.name!r}: needs {what}")
        if self.feat.shape[0] < self.num_node and not self.empty_feat:
            raise ValueError(
                f"feature matrix has {self.feat.shape[0]} rows for a "
                f"{self.num_node}-node graph — a truncated/partial feature "
                "file. Set Dataset.empty_feat=True only for an intentional "
                "mock table (SAMGRAPH_EMPTY_FEAT analog)."
            )
