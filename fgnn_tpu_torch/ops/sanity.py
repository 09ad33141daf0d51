"""Runtime sanity checks, opt-in (port of ``fgnn_tpu/ops/sanity.py``).

The source system's cuda_sanity_check.cu / cpu_sanity_check.cc, switched on
by ``cfg.sanity_check`` or ``FGNN_TPU_SANITY_CHECK`` (SAMGRAPH_SANITY_CHECK,
run_config.cc:91-93). Over each batch an epoch trains on:
  1. no padding (-1) among the batch's declared outputs, no id past the graph;
  2. no train node sampled twice within an epoch (per-epoch bitmap);
  3. every block's valid edges have both locals inside their caps, and its
     padding slots hold -1 (the port's layout: ``src_local`` and
     ``dst_local`` are -1 wherever ``mask`` is False);
  4. no input node past the graph.
The deepest block's src space is the batch's ``input_nodes``: on a dedup hop
that is the hop's unique cap, on the no-dedup last hop (tiered or not)
``[frontier | sampled slots]``. A failed check raises ``ValueError`` (the
reference asserts, and ``python -O`` drops asserts).
"""
from __future__ import annotations

import numpy as np

from ..config import RunConfig, env_flag
from .. import constants
from .sampling import SampledBatch


def _require(ok, msg: str) -> None:
    if not ok:
        raise ValueError(f"sanity check failed: {msg}")


class EpochSanityChecker:
    def __init__(self, num_node: int):
        self.num_node = num_node
        self.seen = np.zeros(num_node, dtype=bool)

    def reset(self) -> None:
        self.seen[:] = False

    def check_batch(self, batch: SampledBatch, plan) -> None:
        out = batch.output_nodes.cpu().numpy()
        valid_out = out[:int(batch.num_output)]
        _require((valid_out >= 0).all(), "padding leaked into valid outputs")
        _require((valid_out < self.num_node).all(), "node id out of range")
        dup = self.seen[valid_out]
        _require(not dup.any(),
                 f"train nodes sampled twice this epoch: {valid_out[dup][:10]}")
        self.seen[valid_out] = True
        inputs = batch.input_nodes.cpu().numpy()
        for bi, blk in enumerate(batch.blocks):
            hop = len(batch.blocks) - 1 - bi
            mask = blk.mask.cpu().numpy()
            src_all = blk.src_local.cpu().numpy()
            dst_all = blk.dst_local.cpu().numpy()
            src, dst = src_all[mask], dst_all[mask]
            _require((src >= 0).all() and (dst >= 0).all(),
                     f"block {bi}: a valid edge has a padding local")
            _require((src_all[~mask] == -1).all() and (dst_all[~mask] == -1).all(),
                     f"block {bi}: a padding slot holds a local id")
            src_cap = (inputs.shape[0] if bi == 0
                       else plan.num_unique_cap[hop])
            _require(src.max(initial=0) < src_cap,
                     f"block {bi}: src local {src.max(initial=0)} >= cap "
                     f"{src_cap}")
            _require(dst.max(initial=0) < plan.num_input_cap[hop],
                     f"block {bi}: dst local {dst.max(initial=0)} >= cap "
                     f"{plan.num_input_cap[hop]}")
        _require((inputs < self.num_node).all(), "input node id out of range")


def make_checker(cfg: RunConfig, num_node: int):
    """The checker an engine runs: one when ``cfg.sanity_check`` or
    ``FGNN_TPU_SANITY_CHECK`` asks for it, else None."""
    if cfg.sanity_check or env_flag(constants.ENV_SANITY_CHECK):
        return EpochSanityChecker(num_node)
    return None
