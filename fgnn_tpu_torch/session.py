"""Reference-compatible session API (port of ``fgnn_tpu/session.py``).

The source system's Python surface, ``samgraph.common.SamGraphBasics`` and
``samgraph.torch`` (adapter.py), so code written against it maps one to one:

    import fgnn_tpu_torch.session as sam
    sam.config({...})
    sam.data_init()
    sam.sample_init(worker_id, ctx)      # ctx: the device, "cuda" by default
    sam.train_init(worker_id, ctx)
    sam.extract_start(count)
    sam.sample_once()
    key = sam.get_next_batch()
    blocks, feat, label = sam.get_blocks(key, num_layer)
    ...
    sam.report_step_average(epoch, step)
    sam.shutdown()

One process: ``sample_init`` / ``train_init`` build the engine on ``ctx``
(arch0: ``HostSamplingEngine``; arch1-4 and 7: ``OneChipEngine``; arch5:
``SwitcherEngine`` after ``switch_init``, else ``AsyncFactoredEngine`` with
``async_train``, else ``FactoredEngine``; arch6: ``SGNNEngine``). For arch5
and arch6 ``ctx`` is a list of role devices, or one device name whose first
S + T (arch6: W) devices are taken (``parallel.mesh.role_devices``).
``sample_once`` draws from the one-device engine's own sampler generator
with its dedup mode, and ``get_blocks`` extracts through the engine's
feature path, so a loop over the session trains on the batches and features
of ``run_epoch``; the multi-device engines run whole epochs
(``run_epoch``), as in the reference.
"""
from __future__ import annotations

import dataclasses
import queue
from typing import Dict, Optional

import numpy as np
import torch

from .config import RunArch, RunConfig
from .data import build_alias_tables, load_dataset, make_synthetic_dataset
from .ops.extract import device_gather, host_gather, host_table, label_gather
from .utils import Timer, get_logger
from .utils.profiler import Profiler

log = get_logger(__name__)


def build_engine(cfg: RunConfig, ds, ctx):
    """The engine of ``cfg.arch`` (fgnn_tpu/session.py:109-138). ``ctx`` is
    the device; for arch5 and arch6 a list of role devices, or a device
    name whose first S + T (arch6: W) devices are taken
    (``parallel.mesh.role_devices``)."""
    if cfg.arch in (RunArch.ARCH5, RunArch.ARCH6):
        from .parallel.mesh import role_devices

        devices = role_devices(cfg, ctx)
        if cfg.arch == RunArch.ARCH6:
            from .parallel.factored import SGNNEngine

            return SGNNEngine(cfg, ds, devices)
        if cfg.have_switcher:
            from .parallel.switcher import SwitcherEngine

            return SwitcherEngine(cfg, ds, devices)
        if cfg.async_train:
            from .parallel.async_dp import AsyncFactoredEngine

            return AsyncFactoredEngine(cfg, ds, devices)
        from .parallel.factored import FactoredEngine

        return FactoredEngine(cfg, ds, devices)
    if cfg.arch == RunArch.ARCH0:
        from .host_engine import HostSamplingEngine

        return HostSamplingEngine(cfg, ds, ctx)
    from .engine import OneChipEngine

    return OneChipEngine(cfg, ds, ctx)


class _Session:
    def __init__(self):
        self.cfg: Optional[RunConfig] = None
        self.ds = None
        self.engine = None
        self._extra: dict = {}
        self._batches: Dict[int, object] = {}
        self._pending: "queue.Queue" = queue.Queue()
        self._batch_iter = None
        self._epoch = 0

    # -- samgraph_config / data_init ------------------------------------
    def config(self, run_config: dict) -> None:
        field_names = {f.name for f in dataclasses.fields(RunConfig)}
        known = {k: v for k, v in run_config.items() if k in field_names}
        self._extra = {k: v for k, v in run_config.items()
                       if k not in field_names}
        self.cfg = RunConfig.from_dict(known)

    def data_init(self) -> None:
        if self.cfg is None:
            raise RuntimeError("call config() first")
        t_load = Timer()
        if self.cfg.dataset == "synthetic":
            self.ds = make_synthetic_dataset(
                num_node=int(self._extra.get("synthetic_nodes", 100_000)),
                avg_degree=15, feat_dim=128, num_class=64,
                seed=self.cfg.seed,
            )
        else:
            self.ds = load_dataset(self.cfg.dataset,
                                   root=self.cfg.dataset_root)
        if (self.cfg.sample_type.value.startswith("weighted")
                and self.ds.prob_table is None):
            build_alias_tables(self.ds, seed=self.cfg.seed)
        # the load's wall clock (kLogInitL1LoadDataset, profiler.h:30-57)
        Profiler.get().log_init("init_load_dataset", t_load.passed())

    # -- sample_init / train_init (role setup) ---------------------------
    def sample_init(self, worker_id: int = 0, ctx="cuda") -> None:
        self._ensure_engine(ctx)

    def train_init(self, worker_id: int = 0, ctx="cuda") -> None:
        self._ensure_engine(ctx)

    def switch_init(self, worker_id: int = 0, ctx="cuda",
                    cache_percentage: float = 0.0) -> None:
        """Register the balance switcher (samgraph_switch_init analog,
        operation.cc:357-362): before the engine is built; the epoch tail
        then trains on the sampler and trainer devices."""
        if self.cfg is None:
            raise RuntimeError("call config() first")
        if self.engine is not None:
            raise RuntimeError("switch_init must precede sample_init and "
                               "train_init")
        self.cfg = self.cfg.replace(have_switcher=True,
                                    switch_cache_percentage=cache_percentage)

    def _ensure_engine(self, ctx) -> None:
        if self.engine is not None:
            return
        cfg, ds = self.cfg, self.ds
        if ds is None:
            raise RuntimeError("call data_init() first")
        self.engine = build_engine(cfg, ds, ctx)

    # -- stepwise sampling (arch1-4/7 style) -----------------------------
    def extract_start(self, count: int) -> None:
        """Sample ``count`` batches ahead (samgraph_extract_start)."""
        for _ in range(count):
            self.sample_once()

    def sample_once(self) -> None:
        from .engine import OneChipEngine

        eng = self.engine
        if not isinstance(eng, OneChipEngine):
            raise TypeError("the stepwise API drives the one-device engine "
                            "(arch1-4, 7); arch0, arch5 and arch6 run whole "
                            "epochs via run_epoch")
        if self._batch_iter is None:
            self._batch_iter = eng.shuffler.batches(self._epoch)
        try:
            seeds, n, step = next(self._batch_iter)
        except StopIteration:
            self._epoch += 1
            self._batch_iter = eng.shuffler.batches(self._epoch)
            seeds, n, step = next(self._batch_iter)
        batch = eng.sample(torch.as_tensor(seeds, device=eng.device), n,
                           eng.sample_gen, eng.dedup_last_hop)
        self._pending.put((self._epoch * eng.shuffler.num_step + step, batch))

    def get_next_batch(self) -> int:
        batch_key, batch = self._pending.get()
        self._batches[batch_key] = batch
        return batch_key

    def get_blocks(self, batch_key: int, num_layer: int):
        """get_dgl_blocks analog: ``(blocks, feats, labels)`` for the model,
        the features through the engine's own path."""
        eng = self.engine
        prof = Profiler.get()
        batch = self._batches[batch_key]
        if len(batch.blocks) != num_layer:
            raise ValueError(f"batch has {len(batch.blocks)} blocks, asked "
                             f"for {num_layer}")
        with prof.span(batch_key, "kL1Event_Convert"):
            t_conv = Timer()   # the graph-to-framework conversion
            feats = eng.features(batch)
            labels = label_gather(eng.label_dev, batch.output_nodes)
            prof.log_step(batch_key, "L1_convert_time", t_conv.passed())
        return batch.blocks, feats, labels

    def get_graph_num_src(self, batch_key: int, layer: int) -> int:
        return int(self._batches[batch_key].blocks[layer].num_src)

    def get_graph_num_dst(self, batch_key: int, layer: int) -> int:
        return int(self._batches[batch_key].blocks[layer].num_dst)

    # -- arch7-style accessors (sgnn_dgl apps): the framework samples,
    # the APP extracts features itself via load_subtensor
    # (torch/adapter.py:170-179 analog) --------------------------------
    def get_batch(self, batch_key: int):
        """The whole sampled batch (what the app's model takes)."""
        return self._batches[batch_key]

    def get_graph_input_nodes(self, batch_key: int):
        return self._batches[batch_key].input_nodes

    def get_graph_output_nodes(self, batch_key: int):
        return self._batches[batch_key].output_nodes

    @staticmethod
    def load_subtensor(feat, input_nodes: torch.Tensor) -> torch.Tensor:
        """App-side feature extraction (adapter.py:170-179): rows of
        ``feat`` for the batch, zero rows for padding, on the ids' device.
        A tensor table is read by the row-gather kernel (on a CUDA device);
        a host ndarray (an np.memmap included) is gathered on the host and
        uploaded."""
        if isinstance(feat, np.ndarray):
            rows = host_gather(host_table(feat), input_nodes.cpu())
            return rows.to(input_nodes.device)
        return device_gather(feat, input_nodes)

    def release_batch(self, batch_key: int) -> None:
        self._batches.pop(batch_key, None)

    # -- meta getters (samgraph_num_class etc.) --------------------------
    def num_class(self) -> int:
        return self.ds.num_class

    def feat_dim(self) -> int:
        return self.ds.feat_dim

    def num_epoch(self) -> int:
        return self.cfg.num_epoch

    def steps_per_epoch(self) -> int:
        eng = self.engine
        if hasattr(eng, "shuffler"):
            return eng.shuffler.num_step
        return eng.num_step   # the multi-device engines

    # -- profiler passthrough --------------------------------------------
    def report_step_average(self, epoch: int, step: int) -> str:
        return Profiler.get().report_step_average(epoch, step)

    def report_init(self) -> str:
        """samgraph_report_init analog."""
        return Profiler.get().report_init()

    def get_log_epoch_value(self, epoch: int, item: str) -> float:
        return Profiler.get().get_epoch_value(epoch, item)

    def get_log_step_value(self, key: int, item: str) -> float:
        return Profiler.get().get_step_value(key, item)

    def dump_trace(self, path: str = "trace.json") -> None:
        Profiler.get().dump_trace(path)

    def shutdown(self) -> None:
        self.engine = None
        self._batches.clear()
        self._batch_iter = None


_session = _Session()

# module-level API (samgraph.torch style)
config = _session.config
data_init = _session.data_init
sample_init = _session.sample_init
train_init = _session.train_init
switch_init = _session.switch_init
extract_start = _session.extract_start
sample_once = _session.sample_once
get_next_batch = _session.get_next_batch
get_blocks = _session.get_blocks
get_dgl_blocks = _session.get_blocks         # migration alias (adapter.py name)
get_dgl_blocks_with_weights = _session.get_blocks  # weights ride on Block.weights
get_graph_num_src = _session.get_graph_num_src
get_graph_num_dst = _session.get_graph_num_dst
get_batch = _session.get_batch
get_graph_input_nodes = _session.get_graph_input_nodes
get_graph_output_nodes = _session.get_graph_output_nodes
load_subtensor = _session.load_subtensor
release_batch = _session.release_batch
num_class = _session.num_class
feat_dim = _session.feat_dim
num_epoch = _session.num_epoch
steps_per_epoch = _session.steps_per_epoch
report_step_average = _session.report_step_average
report_init = _session.report_init
get_log_epoch_value = _session.get_log_epoch_value
get_log_step_value = _session.get_log_step_value
dump_trace = _session.dump_trace
shutdown = _session.shutdown


def _reset_for_tests():
    _session.shutdown()
    _session.__init__()
