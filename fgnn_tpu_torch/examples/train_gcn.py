"""Per-model wrapper (reference example/samgraph parity): trains gcn.

    python -m fgnn_tpu_torch.examples.train_gcn [train_gnn's arguments]
"""
import sys

from .train_gnn import main

if __name__ == "__main__":
    sys.exit(main(["--model", "gcn", *sys.argv[1:]]))
