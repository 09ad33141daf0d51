"""Loss, optimizer, train and eval steps (port of ``fgnn_tpu/train/loop.py``)."""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch

from ..ops.sampling import SampledBatch


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over rows with label >= 0, in float32; also
    returns the accuracy over the same rows."""
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    logits = logits.float()
    ce = torch.logsumexp(logits, -1) - logits.gather(1, safe[:, None])[:, 0]
    n = valid.sum().clamp(min=1)
    loss = torch.where(valid, ce, 0).sum() / n
    acc = (valid & (logits.argmax(-1) == safe)).sum() / n
    return loss, acc


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 0.003,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """``optax.adam(lr)``, or ``optax.adamw(lr, weight_decay)`` when
    ``weight_decay > 0`` (decoupled decay, as optax applies it)."""
    if weight_decay > 0:
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: SampledBatch,
    feats: torch.Tensor,
    labels: torch.Tensor,
    dst_caps: Sequence[int],
    batch_size: int,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward, loss on the seed rows, backward, optimizer update. Returns
    (loss, acc) as device scalars; ``generator`` draws dropout masks."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    logits = model(batch, feats, dst_caps, generator=generator)
    loss, acc = masked_cross_entropy(logits[:batch_size], labels[:batch_size])
    loss.backward()
    optimizer.step()
    return loss.detach(), acc


def eval_step(
    model: torch.nn.Module,
    batch: SampledBatch,
    feats: torch.Tensor,
    labels: torch.Tensor,
    dst_caps: Sequence[int],
    batch_size: int,
) -> torch.Tensor:
    """Deterministic forward (no dropout, no autograd); the accuracy over
    the seed rows as a device scalar."""
    model.eval()
    with torch.no_grad():
        logits = model(batch, feats, dst_caps)
        _, acc = masked_cross_entropy(logits[:batch_size], labels[:batch_size])
    return acc
