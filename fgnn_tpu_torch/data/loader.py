"""Binary dataset loader, mmap-backed (the port's copy of
``fgnn_tpu/data/loader.py``).

Loads the source system's on-disk format, ``meta.txt`` plus flat ``.bin``
files, as Engine::LoadGraphDataset does (engine.cc:73-264): ids are uint32
on disk (viewed as int32), features float32, labels uint64 (converted to
int32). The feature table stays an ``np.memmap``, so a table larger than
host RAM is read page by page; this is the host-resident case the engine's
cache paths serve. The empty-feat mode (SAMGRAPH_EMPTY_FEAT analog,
engine.cc:138-155) substitutes a small fake feature table.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .. import constants
from ..utils import get_logger
from .schema import Dataset

log = get_logger(__name__)


def parse_meta(path: str) -> Dict[str, int]:
    """Parse meta.txt: whitespace-separated ``KEY value`` lines
    (engine.cc:86-99)."""
    meta: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            kv = line.split()
            if len(kv) < 2:
                break
            meta[kv[0]] = int(kv[1])
    return meta


def _mmap(path: str, dtype, shape) -> np.ndarray:
    return np.memmap(path, dtype=dtype, mode="r", shape=shape)


def _opt_mmap(path: str, dtype, shape) -> Optional[np.ndarray]:
    return _mmap(path, dtype, shape) if os.path.exists(path) else None


def _opt_int32(path: str, shape) -> Optional[np.ndarray]:
    a = _opt_mmap(path, np.uint32, shape)
    return None if a is None else a.view(np.int32)


def _root(root: Optional[str]) -> str:
    return root or os.environ.get(constants.ENV_DATASET_ROOT,
                                  constants.DEFAULT_DATASET_ROOT)


def load_dataset(
    name: str,
    root: Optional[str] = None,
    empty_feat: int = 0,
) -> Dataset:
    """Load ``<root>/<name>`` in the source system's binary layout."""
    d = os.path.join(_root(root), name)
    meta = parse_meta(os.path.join(d, constants.META_FILE))

    num_node = meta[constants.META_NUM_NODE]
    num_edge = meta[constants.META_NUM_EDGE]
    feat_dim = meta[constants.META_FEAT_DIM]

    indptr = _mmap(os.path.join(d, constants.INDPTR_FILE), np.uint32,
                   (num_node + 1,))
    indices = _mmap(os.path.join(d, constants.INDICES_FILE), np.uint32,
                    (num_edge,)).view(np.int32)

    feat_path = os.path.join(d, constants.FEAT_FILE)
    is_empty_feat = not (os.path.exists(feat_path) and empty_feat == 0)
    if not is_empty_feat:
        feat = _mmap(feat_path, np.float32, (num_node, feat_dim))
    else:
        fake_nodes = 1 << (empty_feat or 20)
        log.warning("feat.bin missing or empty_feat set: fake feat table of "
                    "%d rows", fake_nodes)
        feat = np.zeros((min(fake_nodes, num_node), feat_dim), dtype=np.float32)

    label_path = os.path.join(d, constants.LABEL_FILE)
    if os.path.exists(label_path):
        label = np.asarray(
            _mmap(label_path, np.uint64, (num_node,))
        ).astype(np.int32)
    else:
        label = np.zeros((num_node,), dtype=np.int32)

    def _set(fname, key):
        return np.asarray(
            _mmap(os.path.join(d, fname), np.uint32, (meta[key],))
        ).astype(np.int32)

    ds = Dataset(
        name=name,
        num_node=num_node,
        num_edge=num_edge,
        num_class=meta[constants.META_NUM_CLASS],
        indptr=np.asarray(indptr).astype(np.int64),
        indices=indices,
        feat=feat,
        label=label,
        train_set=_set(constants.TRAIN_SET_FILE, constants.META_NUM_TRAIN_SET),
        test_set=_set(constants.TEST_SET_FILE, constants.META_NUM_TEST_SET),
        valid_set=_set(constants.VALID_SET_FILE, constants.META_NUM_VALID_SET),
        prob_table=_opt_mmap(os.path.join(d, constants.PROB_TABLE_FILE),
                             np.float32, (num_edge,)),
        alias_table=_opt_int32(os.path.join(d, constants.ALIAS_TABLE_FILE),
                               (num_edge,)),
        prob_prefix_table=_opt_mmap(
            os.path.join(d, constants.PROB_PREFIX_TABLE_FILE), np.float32,
            (num_edge,)),
        in_degrees=_opt_int32(os.path.join(d, constants.IN_DEGREE_FILE),
                              (num_node,)),
        out_degrees=_opt_int32(os.path.join(d, constants.OUT_DEGREE_FILE),
                               (num_node,)),
        empty_feat=is_empty_feat and feat.shape[0] < num_node,
    )
    ds.validate()
    return ds


def load_cache_ranking(name: str, policy_file: str,
                       root: Optional[str] = None) -> np.ndarray:
    """Load a precomputed cache ranking file (cache_by_*.bin)."""
    d = os.path.join(_root(root), name)
    meta = parse_meta(os.path.join(d, constants.META_FILE))
    return np.asarray(
        _mmap(os.path.join(d, policy_file), np.uint32,
              (meta[constants.META_NUM_NODE],))
    ).astype(np.int32)
