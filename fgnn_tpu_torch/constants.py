"""Framework-wide constants (the port's copy of ``fgnn_tpu/constants.py``).

The on-disk dataset file names and meta keys of the source system's
``samgraph/common/constant.{h,cc}``, so datasets written by its ``datagen/``
tooling, or by :func:`fgnn_tpu_torch.data.write_dataset`, load unchanged.
"""

# ---------------------------------------------------------------------------
# Dataset binary-format file names (constant.cc:23-42)
# ---------------------------------------------------------------------------
META_FILE = "meta.txt"
FEAT_FILE = "feat.bin"
LABEL_FILE = "label.bin"
INDPTR_FILE = "indptr.bin"
INDICES_FILE = "indices.bin"
TRAIN_SET_FILE = "train_set.bin"
TEST_SET_FILE = "test_set.bin"
VALID_SET_FILE = "valid_set.bin"

PROB_TABLE_FILE = "prob_table.bin"
ALIAS_TABLE_FILE = "alias_table.bin"
PROB_PREFIX_TABLE_FILE = "prob_prefix_table.bin"

IN_DEGREE_FILE = "in_degrees.bin"
OUT_DEGREE_FILE = "out_degrees.bin"
CACHE_BY_DEGREE_FILE = "cache_by_degree.bin"
CACHE_BY_HEURISTIC_FILE = "cache_by_heuristic.bin"
CACHE_BY_DEGREE_HOP_FILE = "cache_by_degree_hop.bin"
CACHE_BY_FAKE_OPTIMAL_FILE = "cache_by_fake_optimal.bin"
CACHE_BY_RANDOM_FILE = "cache_by_random.bin"

# meta.txt keys (constant.cc:44-50)
META_NUM_NODE = "NUM_NODE"
META_NUM_EDGE = "NUM_EDGE"
META_FEAT_DIM = "FEAT_DIM"
META_NUM_CLASS = "NUM_CLASS"
META_NUM_TRAIN_SET = "NUM_TRAIN_SET"
META_NUM_TEST_SET = "NUM_TEST_SET"
META_NUM_VALID_SET = "NUM_VALID_SET"

# ---------------------------------------------------------------------------
# Environment variables (constant.cc:52-59, the reference's names)
# ---------------------------------------------------------------------------
ENV_PROFILE_LEVEL = "FGNN_TPU_PROFILE_LEVEL"
ENV_LOG_LEVEL = "FGNN_TPU_LOG_LEVEL"
ENV_LOG_NODE_ACCESS = "FGNN_TPU_LOG_NODE_ACCESS"
ENV_SANITY_CHECK = "FGNN_TPU_SANITY_CHECK"
ENV_DUMP_TRACE = "FGNN_TPU_DUMP_TRACE"
ENV_EMPTY_FEAT = "FGNN_TPU_EMPTY_FEAT"
ENV_DATASET_ROOT = "FGNN_TPU_DATASET_ROOT"

# ---------------------------------------------------------------------------
# Numeric constants
# ---------------------------------------------------------------------------
# Sentinel for "no entry" (constant.h:71 kEmptyKey = 0xffffffff): ids are
# int32 and -1 pads every sampled-edge and unique-node buffer.
EMPTY_KEY = -1

# Workspace over-allocation scale (constant.h:78): the reference rounds
# scratch allocations up by 1.25x; the same factor sizes the static padded
# shapes from expected batch sizes.
ALLOC_SCALE = 1.25

# Default dataset root (datagen/README.md:7)
DEFAULT_DATASET_ROOT = "/graph-learning/samgraph"
