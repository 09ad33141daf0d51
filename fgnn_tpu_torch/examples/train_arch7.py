"""arch7-style app: the framework samples, the app extracts features itself
(port of ``examples/train_arch7.py``).

    python -m fgnn_tpu_torch.examples.train_arch7 [--device cpu]

The source system's example/samgraph/sgnn_dgl/train_*.py: samgraph samples
only, and the app gathers its own feature and label tensors with
``load_subtensor`` (torch/adapter.py:170-179). Here the app drives
:mod:`fgnn_tpu_torch.session` for sampling, gathers from the tensors it owns
(``load_subtensor``: the row-gather kernel on a CUDA device) and trains a
GraphSAGE model of its own with ``build_model``, ``make_optimizer`` and
``train_step``, which shows the sampler usable on its own.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import session as sam
from ..models.gnn import build_model
from ..ops import cuda_lib
from ..ops.extract import label_gather
from ..train.loop import make_optimizer, train_step
from ..utils.logging import log_test_result

HIDDEN = 64
LR = 0.01


def main(argv=None) -> int:
    p = argparse.ArgumentParser("fgnn_tpu_torch arch7 app")
    p.add_argument("--device", default="cuda")
    p.add_argument("--synthetic-nodes", type=int, default=50_000)
    p.add_argument("--batch-size", type=int, default=1000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--fanout", nargs="+", type=int, default=[10, 10])
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("train_arch7: no CUDA device; pass --device cpu to run on the "
              "CPU", file=sys.stderr)
        return 1

    sam.config(dict(
        dataset="synthetic", model="graphsage", arch="arch7",
        fanout=tuple(args.fanout), batch_size=args.batch_size,
        num_epoch=args.num_epoch, sample_type="khop0", dropout=0.0,
        synthetic_nodes=args.synthetic_nodes,
    ))
    sam.data_init()
    sam.sample_init(0, device)
    sam.train_init(0, device)

    ds = sam._session.ds
    dst_caps = sam._session.engine.dst_caps
    # app-owned tensors (the torch side of arch7)
    feat = torch.as_tensor(np.asarray(ds.feat), device=device)
    label = torch.as_tensor(np.asarray(ds.label).astype(np.int64),
                            device=device)
    model = build_model("graphsage", ds.feat_dim, HIDDEN, ds.num_class,
                        len(args.fanout), 0.0,
                        generator=torch.Generator().manual_seed(1)).to(device)
    optimizer = make_optimizer(model.parameters(), LR)
    steps = sam.steps_per_epoch()

    for e in range(args.num_epoch):
        t0 = time.time()
        losses = []
        for _ in range(steps):
            sam.sample_once()
            key = sam.get_next_batch()
            feats = sam.load_subtensor(feat, sam.get_graph_input_nodes(key))
            labels = label_gather(label, sam.get_graph_output_nodes(key))
            loss, _ = train_step(model, optimizer, sam.get_batch(key), feats,
                                 labels, dst_caps, args.batch_size)
            losses.append(loss)
            sam.release_batch(key)
        loss = float(torch.stack(losses).mean())   # one sync an epoch
        print(f"Epoch {e:05d} | Time {time.time() - t0:.4f} | "
              f"Loss {loss:.4f}", flush=True)
    log_test_result("epoch_time", f"{time.time() - t0:.4f}")
    for name, n in sorted(cuda_lib.launches.items()):
        log_test_result(f"launches:{name}", str(n))
    sam.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
