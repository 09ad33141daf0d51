"""Asynchronous data-parallel training, arch5's async variant (port of
``fgnn_tpu/parallel/async_dp.py``).

The source system's async trainers (multi_gpu/async/train_graphsage.py)
skip the per-step gradient all-reduce: each GPU steps a local optimizer and
folds its updates into a shared CPU model. The reference keeps the same
property by local SGD with periodic averaging, and so does the port: each
logical trainer holds its own model and optimizer and steps on its own
batch, with no reduce a group; every ``async_sync_every`` groups the
parameters and the optimizer's moments are averaged over the replicas
(summed in logical order on the first trainer's device, then divided).
``async_sync_every=1`` averages after every group.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import torch

from ..config import RunConfig
from ..data.schema import Dataset
from ..ops.extract import label_gather
from ..train.loop import make_optimizer, masked_cross_entropy
from ..utils import get_logger
from .factored import FactoredEngine

log = get_logger(__name__)


def _mean(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean of replicas' tensors, summed in logical order on the first
    one's device."""
    total = ts[0].clone()
    for t in ts[1:]:
        total += t.to(total.device)
    return total / len(ts)


class AsyncFactoredEngine(FactoredEngine):
    """arch5 with async trainers: a model and an optimizer a trainer,
    periodic averaging in place of the per-group gradient reduce."""

    def __init__(self, cfg: RunConfig, ds: Dataset, devices: Sequence, **kw):
        super().__init__(cfg, ds, devices, **kw)
        log.info("AsyncFactoredEngine: %d local replicas, averaging every %d "
                 "groups", self.roles.num_trainer,
                 max(1, cfg.async_sync_every))

    def _init_model(self, device: torch.device) -> None:
        """Every trainer's replica and optimizer, the first one's state
        copied to the others (before a checkpoint is restored)."""
        super()._init_model(device)
        cfg = self.cfg
        self.optimizers: List[torch.optim.Optimizer] = [self.optimizer]
        for i, dev in enumerate(self.roles.trainer_devices[1:], 1):
            self.replicas[i] = copy.deepcopy(self.model).to(dev)
            self.optimizers.append(make_optimizer(
                self.replicas[i].parameters(), cfg.lr, cfg.weight_decay))
        self._groups_since_sync = 0

    def _step_group(self, batches, feats, devices, gens) -> None:
        """Every replica steps on its own batch; the group's loss and
        accuracy are the unweighted means over the replicas, as in the
        reference."""
        B = self.cfg.batch_size
        dev0 = devices[0]
        losses, accs = [], []
        for i, (batch, f, dev, gen) in enumerate(zip(batches, feats, devices,
                                                     gens)):
            model, opt = self.replicas[i], self.optimizers[i]
            model.train()
            opt.zero_grad(set_to_none=True)
            logits = model(batch, f, self.dst_caps, generator=gen)
            labels = label_gather(self._label(dev), batch.output_nodes)
            loss, acc = masked_cross_entropy(logits[:B], labels[:B])
            loss.backward()
            opt.step()
            losses.append(loss.detach().to(dev0))
            accs.append(acc.to(dev0))
        self._stats.append(torch.stack([torch.stack(losses).mean(),
                                        torch.stack(accs).float().mean()]))
        self._groups_since_sync += 1
        if self._groups_since_sync >= max(1, self.cfg.async_sync_every):
            self._average()
            self._groups_since_sync = 0

    def _replica_tensors(self, i: int) -> List[torch.Tensor]:
        """Replica i's parameters and its optimizer's float state."""
        out = list(self.replicas[i].parameters())
        for p in self.replicas[i].parameters():
            out += [v for v in self.optimizers[i].state.get(p, {}).values()
                    if torch.is_tensor(v) and v.is_floating_point()
                    and v.dim() > 0]
        return out

    @torch.no_grad()
    def _average(self) -> None:
        """Every replica's parameters and Adam moments set to their mean
        over the replicas."""
        T = len(self.optimizers)
        if T == 1:
            return
        for ts in zip(*(self._replica_tensors(i) for i in range(T))):
            mean = _mean(ts)
            for t in ts:
                t.copy_(mean)

    @torch.no_grad()
    def consolidated_state(self) -> Dict[str, torch.Tensor]:
        """The replica-averaged parameters (the reference's shared CPU
        model), on the first trainer's device."""
        states = [self.replicas[i].state_dict()
                  for i in range(len(self.optimizers))]
        return {k: _mean([s[k] for s in states]) for k in states[0]}

    def _eval_model(self) -> torch.nn.Module:
        """A copy of the model holding the replica-averaged parameters; the
        replicas are left as they are."""
        model = copy.deepcopy(self.model)
        model.load_state_dict(self.consolidated_state())
        return model

    def _ckpt_state(self) -> dict:
        return {"replicas": [self.replicas[i].state_dict()
                             for i in range(len(self.optimizers))],
                "optimizers": [o.state_dict() for o in self.optimizers],
                "groups_since_sync": self._groups_since_sync}

    def _load_ckpt_state(self, state: dict) -> None:
        for i, (m, o) in enumerate(zip(state["replicas"],
                                       state["optimizers"])):
            self.replicas[i].load_state_dict(m)
            self.optimizers[i].load_state_dict(o)
        self._groups_since_sync = state["groups_since_sync"]
