"""Per-model wrapper (reference example/samgraph parity): trains pinsage.

    python -m fgnn_tpu_torch.examples.train_pinsage [train_gnn's arguments]
"""
import sys

from .train_gnn import main

if __name__ == "__main__":
    sys.exit(main(["--model", "pinsage", *sys.argv[1:]]))
