"""The collectives of the parallel steps, and the split the layers read.

A data-parallel step runs its forward and backward inside
:func:`data_parallel`: the training BatchNorm (``models/layers.py``) sums
its per-channel statistics over the mesh's ranks, so they are the global
batch's, and the ConvNet's dropout draws the global batch's mask and keeps
this rank's rows. Outside it the layers are those of one device.

Under a data x spatial mesh (``parallel/spatial.py``) the block also says
that the volume's depth is split: the layers then take their neighbours'
boundary planes (:func:`halo`) before a conv, the backbone gathers the
depth (:func:`gather_depth`) at the cut, and each reduction names its
group through :class:`Split`: the BN statistics over the whole world before
the cut and over the data group after it (:func:`past_the_cut`), instance
norm over the spatial group, the loss over the data group.

Under a data x spatial x model mesh (``parallel/tensor.py``) the split
also names the model group, over which the channels of the sharded layers
lie: a conv that needs every input channel takes them with
:func:`gather_channels`, a conv that holds a slice of the input channels
sums its partial output with :func:`reduce_partial`, and a layer whose
channels are sharded while its input is whole takes its slice with
:func:`scatter_channels`. The gradients follow one convention: the
gradient a rank holds of a whole (replicated) activation is the whole
gradient, and of a sharded one its own slice's.

The reductions are sum-all-reduces or broadcasts, with the tensors of one
dtype flattened into one buffer: those are the two that the ``gloo``
backend runs on CUDA tensors as well as CPU ones, and one call a dtype
keeps the count of collectives a step makes small. The halo and the cut
use ``all_gather``; the row exchange of the sharded cache uses
``all_to_all`` where the backend has it (NCCL, gloo on CPU tensors) and a
sum of zero-padded buffers elsewhere.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Split:
    """How this rank's activations lie over the ranks: the batch rows split
    over ``rows`` and the volume depth over ``depth`` (each a mesh view with
    ``group``, ``rank``, ``size``; None: whole on this rank). ``both`` is the
    view over the two together (the world of a data x spatial mesh).
    ``model`` is the view over which the sharded layers' channels lie
    (None: every layer whole)."""

    rows: object = None
    depth: object = None
    both: object = None
    model: object = None

    @property
    def stats(self):
        """The view over which a statistic of the whole batch is summed."""
        if self.depth is None:
            return self.rows
        return self.depth if self.rows is None else self.both


_SPLIT = None


@contextlib.contextmanager
def under_split(split):
    """Within the block the layers read ``split`` (a :class:`Split`, or None:
    no mesh). A block that ``models.layers.checkpointed`` recomputes in the
    backward runs under the split its forward saw."""
    global _SPLIT
    saved, _SPLIT = _SPLIT, split
    try:
        yield
    finally:
        _SPLIT = saved


def data_parallel(mesh, rows: bool = True):
    """Within the block, the layers reduce over ``mesh`` (None: no mesh).

    ``mesh`` is a data mesh (rows split over its ranks) or a data x spatial
    mesh (depth split over the spatial group, rows over the data group, or
    whole on every rank when ``rows`` is off: a micro-batch that does not
    divide over the data ranks)."""
    return under_split(None if mesh is None else mesh.split(rows))


def past_the_cut():
    """Within the block the depth is whole on every rank (the layers past
    the cut); the rows and the channels stay as they were."""
    return under_split(None if _SPLIT is None else
                       dataclasses.replace(_SPLIT, depth=None, both=None))


def current_split():
    """The :class:`Split` of the enclosing :func:`data_parallel` block, or None."""
    return _SPLIT


def current_stats_group():
    """The view over which the enclosing block's batch statistics are summed
    (:attr:`Split.stats`), or None."""
    return None if _SPLIT is None else _SPLIT.stats


def current_depth():
    """The spatial view over which the depth is split here, or None."""
    return None if _SPLIT is None else _SPLIT.depth


def current_model():
    """The model view over which the sharded layers' channels lie here, or None."""
    return None if _SPLIT is None else _SPLIT.model


def _in_memory_order(t: torch.Tensor) -> tuple:
    """(t's elements as a 1-D tensor in memory order, the strides that lay
    them out as t): a view of a contiguous or ``channels_last_3d`` tensor,
    a contiguous copy of any other."""
    if t.is_contiguous():
        return t.reshape(-1), t.stride()
    if t.dim() == 5 and t.is_contiguous(memory_format=torch.channels_last_3d):
        return t.permute(0, 2, 3, 4, 1).reshape(-1), t.stride()
    t = t.contiguous()
    return t.reshape(-1), t.stride()


def _flat_by_dtype(tensors, fn) -> list:
    """Applies ``fn`` in place to one flat buffer per dtype of ``tensors``
    (one copy in, none out); returns views of the buffers with the inputs'
    shapes and, for contiguous and ``channels_last_3d`` inputs, strides."""
    out = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        parts = [_in_memory_order(tensors[i].detach()) for i in idx]
        flat = torch.cat([part for part, _ in parts])
        fn(flat)
        offset = flat.storage_offset()
        for i, (part, strides) in zip(idx, parts):
            out[i] = flat.as_strided(tensors[i].shape, strides, offset)
            offset += part.numel()
    return out


def all_reduce_sum(tensors, mesh) -> list:
    """Each tensor summed over the mesh's ranks (the inputs are left as
    they were); with ``mesh`` None, the tensors themselves."""
    if mesh is None:
        return list(tensors)
    return _flat_by_dtype(list(tensors), lambda flat: dist.all_reduce(flat, group=mesh.group))


def broadcast(tensors, mesh, src: int = 0) -> list:
    """Rank ``src``'s values of each tensor, on every rank."""
    if mesh is None:
        return list(tensors)
    return _flat_by_dtype(list(tensors),
                          lambda flat: dist.broadcast(flat, src, group=mesh.group))


def gather_rows(tensors: dict, mesh) -> dict:
    """Every rank's rows of each tensor, rank by rank, on every rank.

    Each rank writes its rows (the same count on every rank) into its block
    of a zeroed buffer of the mesh's rows and the buffers are summed, which
    is exact (a value plus zeros). Booleans travel as int32. Numpy arrays
    become tensors on the mesh's device.
    """
    if mesh is None:
        return dict(tensors)
    keys, bufs, kinds = list(tensors), [], []
    for k in keys:
        t = torch.as_tensor(tensors[k], device=mesh.device)
        kinds.append(t.dtype)
        t = t.to(torch.int32) if t.dtype == torch.bool else t
        n = t.shape[0]
        buf = torch.zeros((mesh.size * n, *t.shape[1:]), dtype=t.dtype, device=mesh.device)
        buf[mesh.rank * n:(mesh.rank + 1) * n] = t
        bufs.append(buf)
    out = all_reduce_sum(bufs, mesh)
    return {k: v.to(torch.bool) if kind == torch.bool else v
            for k, v, kind in zip(keys, out, kinds)}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the mesh whose gradient is the sum of the ranks' gradients:
    each rank's loss depends on every rank's input through the sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.contiguous().clone()
        dist.all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.group)
        return grad, None


def differentiable_all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh, differentiable; ``x`` itself without a mesh."""
    return x if mesh is None else _AllReduceSum.apply(x, mesh)


def _all_gather(t: torch.Tensor, view) -> list:
    """Every rank's ``t`` (the same shape on each) over ``view``, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(view.size)]
    dist.all_gather(parts, t, group=view.group)
    return parts


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(N, C, D, H, W) -> its (N, D, H, W, C) contiguous tensor (a view of a
    ``channels_last_3d`` one)."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def _ncdhw(y: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_ndhwc`: a ``channels_last_3d`` view."""
    return y.permute(0, 4, 1, 2, 3)


class _Halo(torch.autograd.Function):
    """The slab with ``lo`` planes of its left neighbour before it and ``hi``
    of its right neighbour after it; ``fill`` at the volume's ends. The
    backward hands each halo plane's gradient back to its owner, which adds
    it into that boundary plane."""

    @staticmethod
    def forward(ctx, x, view, lo, hi, fill):
        ctx.view, ctx.lo, ctx.hi = view, lo, hi
        y = _ndhwc(x)
        depth = y.shape[1]
        # each rank's first hi planes (its left neighbour's right halo) and
        # last lo planes (its right neighbour's left halo)
        parts = _all_gather(torch.cat([y[:, :hi], y[:, depth - lo:]], 1), view)
        s, n = view.rank, view.size

        def edge(planes):
            return torch.full((y.shape[0], planes, *y.shape[2:]), fill, dtype=y.dtype,
                              device=y.device)

        left = parts[s - 1][:, hi:] if s > 0 else edge(lo)
        right = parts[s + 1][:, :hi] if s < n - 1 else edge(hi)
        return _ncdhw(torch.cat([left, y, right], 1))

    @staticmethod
    def backward(ctx, grad):
        lo, hi, view = ctx.lo, ctx.hi, ctx.view
        g = _ndhwc(grad)
        depth = g.shape[1] - lo - hi
        parts = _all_gather(torch.cat([g[:, :lo], g[:, lo + depth:]], 1), view)
        s, n = view.rank, view.size
        out = g[:, lo:lo + depth].clone()
        if s > 0 and hi:  # my first planes were my left neighbour's right halo
            out[:, :hi] += parts[s - 1][:, lo:]
        if s < n - 1 and lo:  # my last planes were my right neighbour's left halo
            out[:, depth - lo:] += parts[s + 1][:, :lo]
        return _ncdhw(out), None, None, None, None


def halo(x: torch.Tensor, view, lo: int, hi: int, fill: float = 0.0) -> torch.Tensor:
    """``x`` (N, C, D, H, W), this rank's depth slab over ``view``, with its
    left neighbour's last ``lo`` planes before it and its right neighbour's
    first ``hi`` planes after it (``fill`` beyond the volume's ends: 0 is a
    conv's zero padding), differentiable; a ``channels_last_3d`` tensor."""
    if lo == 0 and hi == 0:
        return x
    return _Halo.apply(x, view, lo, hi, fill)


class _GatherDepth(torch.autograd.Function):
    """The ranks' slabs joined along depth. The backward sums the gradient
    over the ranks and keeps this rank's slab: each rank's loss is its share
    of the whole, so the replicated layers past the gather each add theirs."""

    @staticmethod
    def forward(ctx, x, view):
        ctx.view, ctx.depth = view, x.shape[2]
        return _ncdhw(torch.cat(_all_gather(_ndhwc(x), view), 1))

    @staticmethod
    def backward(ctx, grad):
        g = _ndhwc(grad).clone()
        dist.all_reduce(g, group=ctx.view.group)
        s, depth = ctx.view.rank, ctx.depth
        return _ncdhw(g[:, s * depth:(s + 1) * depth].contiguous()), None


def gather_depth(x: torch.Tensor, view) -> torch.Tensor:
    """The whole depth of ``x`` (N, C, D, H, W), this rank's slab over
    ``view``, on every rank of it, differentiable; a ``channels_last_3d`` tensor."""
    return _GatherDepth.apply(x, view)


def exchange_rows(tensors: dict, mesh, wanted: list, all_to_all: bool | None = None) -> dict:
    """Rows of a global batch moved between the ranks.

    Rank r holds block r of a global batch (its rows [r b, (r + 1) b), b
    the same on every rank); ``wanted[q]`` lists (as slices, ascending) the
    global rows that rank q needs. Returns this rank's wanted rows of each
    tensor, in order, on the mesh's device. Where the backend has
    ``all_to_all`` (NCCL, or gloo on CPU tensors) each rank is sent only its
    rows; otherwise every rank gathers the whole batch (:func:`gather_rows`)
    and keeps its rows. ``all_to_all`` overrides that choice: it exists for
    the tests, which take the gather on CPU tensors. Booleans travel as
    int32.
    """
    if all_to_all is None:
        all_to_all = mesh.backend == "nccl" or mesh.device.type == "cpu"
    mine = wanted[mesh.rank]
    if not all_to_all:
        rows = gather_rows(tensors, mesh)
        return {k: torch.cat([v[s] for s in mine]) for k, v in rows.items()}
    b = next(iter(tensors.values())).shape[0]

    def local(runs, block):
        """The rows of ``runs`` that lie in ``block``, as local slices of it."""
        lo, hi = block * b, (block + 1) * b
        return [slice(max(s.start, lo) - lo, min(s.stop, hi) - lo) for s in runs
                if s.start < hi and s.stop > lo]

    send_runs = [local(wanted[q], mesh.rank) for q in range(mesh.size)]
    recv_counts = [sum(s.stop - s.start for s in local(mine, q)) for q in range(mesh.size)]
    # every message padded to the longest (gloo takes equal sizes only)
    longest = max(sum(s.stop - s.start for s in local(wanted[q], r))
                  for q in range(mesh.size) for r in range(mesh.size))
    out = {}
    for k, v in tensors.items():
        t = torch.as_tensor(v, device=mesh.device)
        kind = t.dtype
        t = t.to(torch.int32) if kind == torch.bool else t
        send = []
        for runs in send_runs:
            buf = t.new_zeros((longest, *t.shape[1:]))
            rows = torch.cat([t[s] for s in runs]) if runs else t[:0]
            buf[:rows.shape[0]] = rows
            send.append(buf)
        recv = [torch.empty_like(buf) for buf in send]
        dist.all_to_all(recv, send, group=mesh.group)
        out[k] = torch.cat([r[:n] for r, n in zip(recv, recv_counts)]).to(kind)
    return out


def _gather_channel_parts(x: torch.Tensor, view) -> torch.Tensor:
    """Every rank's channels of ``x`` (N, c, D, H, W), joined in rank order:
    (N, c n, D, H, W), a ``channels_last_3d`` tensor."""
    return _ncdhw(torch.cat(_all_gather(_ndhwc(x), view), -1))


def channel_slice(x: torch.Tensor, view) -> torch.Tensor:
    """This rank's slice of the channels (dim 1) of ``x``: the ``view.rank``-th
    of ``view.size`` equal parts."""
    c = x.shape[1] // view.size
    return x[:, view.rank * c:(view.rank + 1) * c]


class _GatherChannels(torch.autograd.Function):
    """The ranks' channel slices joined. The gradient of the whole is either
    each rank's part of a sum (``partial``: the consumer computed a slice of
    its output, so the ranks' gradients add, a reduce-scatter) or the same
    on every rank (the consumer is whole: this rank's slice of it)."""

    @staticmethod
    def forward(ctx, x, view, partial):
        ctx.view, ctx.partial = view, partial
        return _gather_channel_parts(x, view)

    @staticmethod
    def backward(ctx, grad):
        if ctx.partial:
            g = _ndhwc(grad).clone()
            dist.all_reduce(g, group=ctx.view.group)
            grad = _ncdhw(g)
        return channel_slice(grad, ctx.view).contiguous(
            memory_format=torch.channels_last_3d), None, None


def gather_channels(x: torch.Tensor, view, partial: bool = True) -> torch.Tensor:
    """Every channel of ``x`` (N, c, D, H, W), this rank's slice over the
    model ``view``, on every rank of it, differentiable. ``partial``: the
    consumer computes this rank's share of its output (a conv whose output
    channels are sharded), so the backward sums the ranks' gradients before
    each takes its slice; else the consumer is whole on every rank and the
    backward takes this rank's slice of its gradient."""
    return _GatherChannels.apply(x, view, partial)


class _ScatterChannels(torch.autograd.Function):
    """This rank's slice of a whole activation; the backward joins the
    ranks' slices of the gradient, so the whole's gradient is whole."""

    @staticmethod
    def forward(ctx, x, view):
        ctx.view = view
        return channel_slice(x, view)

    @staticmethod
    def backward(ctx, grad):
        return _gather_channel_parts(grad, ctx.view), None


def scatter_channels(x: torch.Tensor, view) -> torch.Tensor:
    """This rank's slice of the channels of a whole ``x`` over the model
    ``view``, differentiable."""
    return _ScatterChannels.apply(x, view)


class _CopyToModel(torch.autograd.Function):
    """A whole tensor that each rank consumes for its share of the output:
    the identity, whose backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, view):
        ctx.view = view
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum([grad], ctx.view)[0], None


def copy_to_model(x: torch.Tensor, view) -> torch.Tensor:
    """``x`` (whole on every rank of the model ``view``: an activation, or a
    replicated parameter such as the ConvNet's PReLU slope) as the input of
    a computation on this rank's share of the channels, differentiable."""
    return _CopyToModel.apply(x, view)


class _ReducePartial(torch.autograd.Function):
    """The sum of the ranks' partial outputs; its gradient is each rank's
    gradient of the whole sum, which is the same on every rank."""

    @staticmethod
    def forward(ctx, x, view):
        y = _ndhwc(x).clone()
        dist.all_reduce(y, group=view.group)
        return _ncdhw(y)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_partial(x: torch.Tensor, view) -> torch.Tensor:
    """``x`` (N, C, D, H, W), this rank's partial sum of a conv over its
    slice of the input channels, summed over the model ``view``,
    differentiable."""
    return _ReducePartial.apply(x, view)


def whole_along(t: torch.Tensor, full: int, dim: int, view) -> torch.Tensor:
    """A parameter ``t`` made whole along ``dim`` (``full`` long) over the
    model ``view``: the ranks' slices joined when it is sharded there,
    else ``t`` itself. Not differentiable: the inference path's fused
    kernels take whole weights."""
    if view is None or t.shape[dim] == full:
        return t
    parts = _all_gather(t.detach().movedim(dim, 0).contiguous(), view)
    return torch.cat(parts, 0).movedim(0, dim).contiguous()
