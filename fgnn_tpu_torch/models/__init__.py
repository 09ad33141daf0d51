"""GNN models and message-passing primitives."""
from .aggregate import gather_src, segment_agg
from .gnn import GAT, GCN, GraphSAGE, PinSAGE, build_model
