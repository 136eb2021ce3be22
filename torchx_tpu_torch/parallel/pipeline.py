"""Pipeline parallelism: GPipe over the ``pp`` mesh axis, the port of
:mod:`torchx_tpu.parallel.pipeline`.

The stacked layer axis of the parameters shards over ``pp``: stage ``s``
holds a contiguous run of ``n_layers / pp`` layers
(``param_specs(cfg, pp=True)``). The batch splits into microbatches; stage
``s`` receives each microbatch's activations from stage ``s - 1``, runs
its layers on them and sends the result to stage ``s + 1``
(:func:`~torchx_tpu_torch.parallel.mesh.send_recv`), and the last stage's
outputs are broadcast to every stage, where the head and the loss run
(the reference sums the masked outputs over ``pp`` to the same effect).
The bubble is the reference's, ``(S - 1) / (M + S - 1)``, but a stage
computes nothing for a microbatch it does not hold: the reference computes
masked values there, which changes no result.

The forward runs every microbatch, then the backward runs them in
reverse, both on an explicit schedule inside one autograd function: every
rank of a ``pp`` group issues its receives, sends and broadcasts in the
same order in the forward and in the backward (on NCCL a mismatch hangs),
whatever order autograd would take. The backward drops the output's
gradient on every stage but the last (each stage computed the same loss
from the same outputs, so summing it over ``pp`` would give the layers
``pp`` times their gradient), passes each microbatch's input gradient one
stage back, and broadcasts stage 0's input gradient to every stage, where
the embedding that every stage holds takes it.

The reference's ``make_pp_mesh(n)`` is ``make_mesh(MeshConfig(pp=n))`` on
a world of ``n`` ranks here.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from torchx_tpu_torch.parallel import mesh as mesh_ops

#: ``body(h, layer_weights) -> h``, or ``(h, aux)`` with ``with_aux``: one
#: layer on a microbatch, its weights one slice of each stacked leaf.
LayerBody = Callable[[torch.Tensor, list], Any]


def validate(n_layers: int, n_stages: int, batch: int, n_microbatches: int) -> None:
    """The reference's two refusals: ``n_layers`` that ``n_stages`` does
    not divide, and a ``batch`` (here a rank's rows) that the microbatches
    do not divide."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by {n_microbatches} microbatches")


def auto_microbatches(requested: int, n_stages: int, rows: int) -> int:
    """The reference's microbatch count: ``requested`` where given, else the
    largest divisor of a rank's ``rows`` up to ``2 * n_stages``
    (``gcd(2 * pp, batch / (dp * fsdp))``)."""
    return requested or math.gcd(2 * n_stages, rows)


def microbatch_rows(rows: int, data_size: int, data_index: int, n_micro: int) -> torch.Tensor:
    """The rows of the whole batch (``rows`` a rank, ``data_size`` ranks)
    that data rank ``data_index`` computes so that its microbatch ``m`` is
    its block of the reference's microbatch ``m``, a contiguous block of the
    whole batch's rows: for each ``m``, block ``data_index`` of rows ``m *
    mb`` to ``(m + 1) * mb`` (``mb = rows * data_size / n_micro``)."""
    if rows % n_micro:
        raise ValueError(f"batch {rows} not divisible by {n_micro} microbatches")
    per = rows // n_micro
    mb = per * data_size
    return (torch.arange(n_micro)[:, None] * mb + data_index * per
            + torch.arange(per)[None, :]).reshape(-1)


def reference_microbatches(x: torch.Tensor, mesh: Any, n_micro: int) -> torch.Tensor:
    """This rank's rows ``x`` (block :attr:`~torchx_tpu_torch.parallel.mesh.Mesh.data_index`
    of the batch) exchanged over ``dp`` x ``fsdp`` for the rows of
    :func:`microbatch_rows`: the reference pipelines the whole batch, so
    its microbatch ``m`` is a contiguous block of the whole batch's rows,
    split over the data ranks inside the stage. A statistic taken over a
    microbatch's rows of every data rank (the MoE router's balance term) is
    then the reference's. Not differentiable (tokens, masks)."""
    idx = microbatch_rows(x.shape[0], mesh.data_size, mesh.data_index, n_micro)
    return mesh_ops.gather_batch(x, mesh)[idx.to(x.device)]


def _stage_apply(body: LayerBody, layers: list, h: torch.Tensor,
                 with_aux: bool) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """This stage's layers on one microbatch; with ``with_aux`` the layers'
    aux values summed over the stage."""
    per_layer = [w.unbind(0) for w in layers]
    auxes = []
    for j in range(layers[0].shape[0]):
        out = body(h, [w[j] for w in per_layer])
        if with_aux:
            h, aux = out
            auxes.append(aux.float())
        else:
            h = out
    return h, torch.stack(auxes).sum(dim=0) if with_aux else None


def _forward(body: LayerBody, mesh: Any, n_micro: int, with_aux: bool, x: torch.Tensor,
             layers: list, keep: bool) -> tuple[torch.Tensor, Optional[torch.Tensor], list]:
    """The forward schedule. -> (the last stage's outputs on every stage,
    the aux total, and with ``keep`` each microbatch's ``(input, output,
    aux)`` with their graphs)."""
    S, s, group = mesh.n_stages, mesh.stage, mesh.pp_group
    xs = x.chunk(n_micro)
    records, outs, aux_sum = [], [], None
    for i in range(n_micro):
        if s == 0:
            inp = xs[i].detach()
        else:
            inp = torch.empty_like(xs[i])
            mesh_ops.send_recv([], [(inp, s - 1)], group)
        if keep:
            inp.requires_grad_(s > 0 or x.requires_grad)
        with torch.enable_grad() if keep else torch.no_grad():
            out, aux = _stage_apply(body, layers, inp, with_aux)
        if s < S - 1:
            mesh_ops.send_recv([(out, s + 1)], [], group)
        else:
            outs.append(out.detach())
        if with_aux:
            aux_sum = aux.detach() if aux_sum is None else aux_sum + aux.detach()
        if keep:
            records.append((inp, out, aux))
    y = torch.cat(outs) if s == S - 1 else torch.empty_like(x)
    mesh_ops.broadcast(y, S - 1, group)
    aux_total = None
    if with_aux:
        # each microbatch's aux is a mean over its own tokens: the sum over
        # the stages' layers, averaged over the microbatches
        aux_total = aux_sum.clone()
        with mesh_ops.collective_range(group):
            dist.all_reduce(aux_total, group=group)
        aux_total = aux_total / n_micro
    return y, aux_total, records


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: tuple, x: torch.Tensor, *layers: torch.Tensor):  # noqa: ANN001, ANN205
        body, mesh, n_micro, with_aux = plan
        ws = [w.detach().requires_grad_(w.requires_grad) for w in layers]
        y, aux_total, records = _forward(body, mesh, n_micro, with_aux, x, ws, keep=True)
        ctx.plan, ctx.ws, ctx.records = plan, ws, records
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return (y, aux_total) if with_aux else y

    @staticmethod
    def backward(ctx, g_y: torch.Tensor, g_aux: Optional[torch.Tensor] = None):  # noqa: ANN001, ANN205
        _, mesh, n_micro, with_aux = ctx.plan
        S, s, group = mesh.n_stages, mesh.stage, mesh.pp_group
        ws = ctx.ws
        trained = [i for i, w in enumerate(ws) if w.requires_grad]
        w_grads: list = [None] * len(ws)
        g_ys = g_y.chunk(n_micro)
        dxs: list = [None] * n_micro
        for i in reversed(range(n_micro)):
            inp, out, aux = ctx.records[i]
            ctx.records[i] = None  # the microbatch's graph goes with its backward
            if s == S - 1:
                g = g_ys[i]  # this stage's own: every stage holds the same
            else:
                g = torch.empty_like(out)
                mesh_ops.send_recv([], [(g, s + 1)], group)
            outputs, grads = [out], [g]
            if with_aux and aux.requires_grad and g_aux is not None:
                outputs.append(aux)
                grads.append(g_aux / n_micro)
            inputs = ([inp] if inp.requires_grad else []) + [ws[j] for j in trained]
            got = torch.autograd.grad(outputs, inputs, grads, allow_unused=True)
            if inp.requires_grad:
                g_inp, got = got[0], got[1:]
                if g_inp is None:
                    g_inp = torch.zeros_like(inp)
                if s > 0:
                    mesh_ops.send_recv([(g_inp, s - 1)], [], group)
                else:
                    dxs[i] = g_inp
            for j, gw in zip(trained, got):
                if gw is not None:
                    w_grads[j] = gw if w_grads[j] is None else w_grads[j] + gw
        dx = None
        if ctx.needs_input_grad[1]:
            # stage 0's input gradient reaches the embedding of every stage
            shape, dtype, device = ctx.x_meta
            dx = torch.cat(dxs) if s == 0 else torch.empty(shape, dtype=dtype, device=device)
            mesh_ops.broadcast(dx, 0, group)
        return (None, dx, *w_grads)


def pipeline_apply(
    body: LayerBody,
    local_layers: list,
    x: torch.Tensor,
    mesh: Any,
    n_microbatches: int,
    with_aux: bool = False,
) -> Any:
    """This stage's ``local_layers`` (stacked leaves ``[n_layers / pp,
    ...]``, this rank's shards) applied to ``x`` (``[rows, ...]``, the same
    on every stage: the embedding's output) in ``n_microbatches``
    microbatches, pipelined over ``mesh``'s ``pp`` stages. -> the last
    stage's output ``[rows, ...]`` on every stage, and with ``with_aux``
    (the body returns ``(h, aux)``) also the aux values summed over every
    stage's layers and averaged over the microbatches, as the reference
    returns them. Differentiable in ``x`` and the layers. Every rank of the
    ``pp`` group must call it with the same arguments' shapes."""
    n_local = local_layers[0].shape[0]
    validate(n_local * mesh.n_stages, mesh.n_stages, x.shape[0], n_microbatches)
    plan = (body, mesh, n_microbatches, with_aux)
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad
                                                           for w in local_layers)):
        return _Pipeline.apply(plan, x, *local_layers)
    y, aux_total, _ = _forward(body, mesh, n_microbatches, with_aux, x, list(local_layers),
                               keep=False)
    return (y, aux_total) if with_aux else y
