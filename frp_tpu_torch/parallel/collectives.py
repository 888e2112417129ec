"""The collectives of the process mesh, as ``torch.distributed`` calls.

Every collective here is an ``all_reduce`` or a ``broadcast``: gloo takes
CUDA tensors for those two only, so the same code runs on gloo on the CPU,
gloo on a card (several ranks sharing one) and NCCL. The autograd-carrying
all-reduces say what their backward does, since each use needs another:

* ``reduce_sum``: a sum forward and a sum backward. A statistic summed over
  the data group (BN's) feeds every rank's loss, so its gradient is the sum
  of every rank's.
* ``reduce_sum_forward``: a sum forward, the identity backward. The softmax
  normaliser summed over the model group: each rank's loss is the same
  number, and each rank's columns get their own share of its gradient.
* ``reduce_sum_backward``: the identity forward, a sum backward. The
  embedding a model group shares: each rank's logits give part of its
  gradient, and the backbone below needs the whole.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from frp_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, forward_sum: bool, backward_sum: bool):
        ctx.group, ctx.backward_sum = group, backward_sum
        if not forward_sum:
            return x.view_as(x)
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        if ctx.backward_sum:
            grad = grad.clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad, None, None, None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(x, group, True, True)


def reduce_sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(x, group, True, False)


def reduce_sum_backward(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(x, group, False, True)


def average_gradients(params: list[torch.Tensor], group, n: int) -> None:
    """Every parameter's gradient, averaged over the group's n ranks (None:
    every rank) in place, through one all_reduce of the gradients joined end
    to end."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= n
    at = 0
    for g in grads:
        g.copy_(flat[at : at + g.numel()].view_as(g))
        at += g.numel()


def mean_over(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of x over the group's n ranks (a new tensor)."""
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out / n


def argmax_over(x: torch.Tensor, offset: int, group) -> torch.Tensor:
    """The argmax along the last axis of a matrix whose columns are split
    over the group, as global column indices: the max of the values, then
    the least global index among the ranks that hold it, so a tie goes to
    the lower index as ``jnp.argmax``'s does. ``offset`` is this rank's
    first column."""
    val, idx = x.max(dim=-1)  # torch takes the first of equal maxima
    best = val.clone()
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
    cand = torch.where(val == best, idx + offset, torch.full_like(idx, torch.iinfo(idx.dtype).max))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
    return cand


def gather_columns(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole matrix of a column-split one, on every rank of this
    process's model row: each rank broadcasts its columns in turn."""
    n_model = mesh.shape[MODEL_AXIS]
    if n_model == 1:
        return x.detach().clone()
    i, j = mesh.position
    group = mesh.get_group(MODEL_AXIS)
    parts = []
    for k in range(n_model):
        part = x.detach().clone() if k == j else torch.empty_like(x)
        dist.broadcast(part, src=int(mesh.ranks[i, k]), group=group)
        parts.append(part)
    return torch.cat(parts, dim=-1)
