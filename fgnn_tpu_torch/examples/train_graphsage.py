"""Per-model wrapper (reference example/samgraph parity): trains graphsage.

    python -m fgnn_tpu_torch.examples.train_graphsage [train_gnn's arguments]
"""
import sys

from .train_gnn import main

if __name__ == "__main__":
    sys.exit(main(["--model", "graphsage", *sys.argv[1:]]))
