"""GNN models and message-passing primitives."""
