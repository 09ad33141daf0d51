"""Per-model wrapper (reference example/samgraph parity): trains gat.

    python -m fgnn_tpu_torch.examples.train_gat [train_gnn's arguments]
"""
import sys

from .train_gnn import main

if __name__ == "__main__":
    sys.exit(main(["--model", "gat", *sys.argv[1:]]))
