"""More than 2^31 edges (int64 ``indptr``) through the port: a mirror of
tests/test_int64_edges.py.

Vertex 0 owns a 2^31-edge range backed by a SPARSE memmap file (holes read
as zeros), and the training vertices own real edge ranges above offset
2^31, so every sampled training hop reads offsets past 2^31. The port keeps
``indptr`` in int64 and needs no x64 switch; it reads an int32 memmap in
place, without a copy. Both engines run one epoch on the CPU: the host
sampler (arch0, the C++ library's int64 offsets) and the device sampler
(``OneChipEngine``, torch int64 offsets). Runs in a subprocess, like the
reference's test.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import numpy as np

from fgnn_tpu_torch.config import RunConfig, SampleType
from fgnn_tpu_torch.data.schema import Dataset
from fgnn_tpu_torch.engine import OneChipEngine
from fgnn_tpu_torch.host_engine import HostSamplingEngine

path = sys.argv[1]
NUM_NODE = 1000
N_TRAIN = 64
DEG_TAIL = 128
HUGE = 2**31                      # vertex 0's degree
NUM_EDGE = HUGE + N_TRAIN * DEG_TAIL

idx = np.memmap(path, dtype=np.int32, mode="w+", shape=(NUM_EDGE,))
rng = np.random.default_rng(0)
idx[HUGE:] = rng.integers(1, N_TRAIN + 1, size=N_TRAIN * DEG_TAIL,
                          dtype=np.int32)
idx.flush()
del idx

indptr = np.zeros(NUM_NODE + 1, dtype=np.int64)
indptr[1] = HUGE
for v in range(1, N_TRAIN + 1):
    indptr[v + 1] = indptr[v] + DEG_TAIL
indptr[N_TRAIN + 2:] = indptr[N_TRAIN + 1]

ds = Dataset(
    name="int64-edges", num_node=NUM_NODE, num_edge=NUM_EDGE, num_class=4,
    indptr=indptr,
    indices=np.memmap(path, dtype=np.int32, mode="r", shape=(NUM_EDGE,)),
    feat=rng.standard_normal((NUM_NODE, 8), dtype=np.float32),
    label=rng.integers(0, 4, NUM_NODE).astype(np.int32),
    train_set=np.arange(1, N_TRAIN + 1, dtype=np.int32),
    test_set=np.arange(1, 9, dtype=np.int32),
    valid_set=np.arange(1, 9, dtype=np.int32),
)
# (no ds.validate(): indices.max() would stream the whole 8.6 GB file)

for st in (SampleType.KHOP0, SampleType.KHOP1):
    cfg = RunConfig(model="graphsage", fanout=(4, 4), batch_size=32,
                    num_hidden=16, sample_type=st, dropout=0.0, lr=0.01,
                    compute_dtype="float32")
    host = HostSamplingEngine(cfg, ds, "cpu")
    r = host.run_epoch(0)
    assert np.isfinite(r["loss"]), r
    seeds, n, _ = next(host.shuffler.batches(1))
    b = host.sample(np.random.default_rng(1), seeds, n)
    edges = sum(int(blk.mask.sum()) for blk in b.blocks)
    # every training vertex has 128 neighbours, all of them training ids
    assert edges == 32 * 4 + int(b.blocks[0].num_dst) * 4, edges
    print("host", st.value, "epoch ok:", r["loss"], edges)

    dev = OneChipEngine(cfg, ds, "cpu")
    r = dev.run_epoch(0)
    assert np.isfinite(r["loss"]) and r["sampled_edges"] > 0, r
    print("device", st.value, "epoch ok:", r["loss"], r["sampled_edges"])
"""


@pytest.mark.slow
def test_int64_indptr_execution(tmp_path):
    script = tmp_path / "run_int64.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "indices.bin")],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for line in ("host khop0", "device khop0", "host khop1", "device khop1"):
        assert line + " epoch ok" in r.stdout, r.stdout
