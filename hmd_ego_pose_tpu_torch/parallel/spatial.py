"""The ``space`` axis: what GSPMD inserts when the image height is split.

The JAX package puts the NHWC height over the mesh's ``space`` axis
(``image_sharding``) and lets GSPMD turn every convolution into a slab
convolution with halo exchanges; it has no module of its own for that.  The
port writes those collectives by hand, each a ``torch.autograd.Function``
over the mesh's space group (``parallel/mesh.py``), on NCHW maps split along
dim -2:

* ``halo``: a slab and the ``top`` / ``bottom`` rows around it from the
  neighbouring slabs (zeros beyond the image);
* ``gather_rows``: the slabs of a level joined into the whole level on every
  rank;
* ``scatter_rows``: a whole level cut to this rank's slab;
* ``space_sum``: the sum over the space group.

Gradients.  A slab has one owner, so its gradient is the whole gradient of
its rows.  A whole value is held by every rank of the space group, and each
rank holds a part of its gradient: the parts sum to it.  Every backward below
keeps that rule, so work split into slabs and work done whole on every rank
both leave each rank a part of every parameter's gradient, and one sum over
the space group (with the data mean, ``train/state.py``) makes it whole.
Training-mode BN's statistics follow the same rule (``nn/core.py``).

Collectives are counted in the mesh's ``CollectiveStats`` under ``halo``,
``gather``, ``space_sum`` and ``<kind>_backward``.  gloo's point-to-point
calls take no CUDA tensors, so the halo rows travel by an all-gather of
every rank's edge rows (on NCCL too: one collective a halo on every
backend); a halo deeper than a slab gathers the whole level.

CUDA graphs.  Every branch below is taken on shapes and ranks, which a
capture fixes, and nothing reads the device from the host, so on a
capturable mesh (``DataMesh.capturable``: NCCL, a card per rank) a
captured forward or backward records these collectives with the rest of
the step or predict (``utils/graphs.py``), each counted per replay; the
buffers they gather into and the zeros they pad with are the graph's.
"""

from __future__ import annotations

import torch

from hmd_ego_pose_tpu_torch.parallel.mesh import DataMesh


def _edges(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """The rows a slab's neighbours need: its first ``bottom`` rows (the halo
    below the slab above) and its last ``top`` rows (above the slab below)."""
    rows = x.shape[-2]
    return torch.cat([x[..., :bottom, :], x[..., rows - top:, :]], dim=-2)


class _Halo(torch.autograd.Function):
    """y = [top rows above the slab, the slab, bottom rows below it].

    Backward: the gradient of a halo row belongs to the neighbour that owns
    the row; each rank sends its halo rows' gradients back (one all-gather)
    and adds what its neighbours send to its own edge rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh, top: int, bottom: int) -> torch.Tensor:
        ctx.mesh, ctx.top, ctx.bottom = mesh, top, bottom
        s, n, rows = mesh.space_rank, mesh.space, x.shape[-2]
        ctx.rows = rows
        if top <= rows and bottom <= rows:
            parts = mesh.all_gather(_edges(x, top, bottom), "halo")
            zeros = x.new_zeros
            above = parts[s - 1][..., bottom:, :] if s > 0 else zeros(*x.shape[:-2], top, x.shape[-1])
            below = parts[s + 1][..., :bottom, :] if s < n - 1 else zeros(*x.shape[:-2], bottom, x.shape[-1])
            return torch.cat([above, x, below], dim=-2)
        whole = torch.cat(mesh.all_gather(x, "halo"), dim=-2)
        whole = torch.nn.functional.pad(whole, (0, 0, top, bottom))
        return whole[..., s * rows:s * rows + top + rows + bottom, :].contiguous()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh, top, bottom, rows = ctx.mesh, ctx.top, ctx.bottom, ctx.rows
        s, n = mesh.space_rank, mesh.space
        if top <= rows and bottom <= rows:
            g_top, g_bottom = grad[..., :top, :], grad[..., top + rows:, :]
            parts = mesh.all_gather(torch.cat([g_top, g_bottom], dim=-2), "halo_backward")
            dx = grad[..., top:top + rows, :].clone()
            if s < n - 1:  # the slab below sends the gradient of its top halo: our last rows
                dx[..., rows - top:, :] += parts[s + 1][..., :top, :]
            if s > 0:  # the slab above, of its bottom halo: our first rows
                dx[..., :bottom, :] += parts[s - 1][..., top:, :]
            return dx, None, None, None
        full = grad.new_zeros(*grad.shape[:-2], n * rows + top + bottom, grad.shape[-1])
        full[..., s * rows:s * rows + top + rows + bottom, :] = grad
        mesh.all_reduce_sum_(full, "halo_backward", "space")
        return full[..., top + s * rows:top + (s + 1) * rows, :].contiguous(), None, None, None


class _Gather(torch.autograd.Function):
    """y = the whole level on every rank.

    Backward: each rank holds a part of the whole level's gradient; the sum
    over the space group (one all-reduce), cut to this rank's rows, is the
    slab's."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh, ctx.rows = mesh, x.shape[-2]
        return torch.cat(mesh.all_gather(x, "gather"), dim=-2)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.contiguous().clone()
        ctx.mesh.all_reduce_sum_(g, "gather_backward", "space")
        s, rows = ctx.mesh.space_rank, ctx.rows
        return g[..., s * rows:(s + 1) * rows, :].contiguous(), None


class _Scatter(torch.autograd.Function):
    """y = this rank's rows of a whole level; no collective.

    Backward: the slab's gradient placed in zeros of the whole level's shape,
    this rank's part of the whole level's gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh, ctx.height = mesh, x.shape[-2]
        return x[..., mesh.height_rows(x.shape[-2]), :].contiguous()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.new_zeros(*grad.shape[:-2], ctx.height, grad.shape[-1])
        g[..., ctx.mesh.height_rows(ctx.height), :] = grad
        return g, None


class _SpaceSum(torch.autograd.Function):
    """y = the sum over the space group, on every rank.

    Backward: the sum over the space group of the gradient's parts."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce_sum_(x.detach().clone(), "space_sum", "space")

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.mesh.all_reduce_sum_(grad.contiguous().clone(), "space_sum_backward", "space"), None


def halo(x: torch.Tensor, mesh: DataMesh, top: int, bottom: int) -> torch.Tensor:
    """The slab ``x`` (NCHW, H its rows) with ``top`` rows of the slabs above
    and ``bottom`` rows of those below (zeros beyond the image)."""
    if top == bottom == 0:
        return x
    return _Halo.apply(x, mesh, top, bottom)


def gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The whole level of which ``x`` is this rank's slab."""
    return _Gather.apply(x, mesh)


def scatter_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """This rank's slab of the whole level ``x``."""
    return _Scatter.apply(x, mesh)


def space_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of ``x`` over the space group."""
    return _SpaceSum.apply(x, mesh)
