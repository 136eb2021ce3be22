"""Sparse Mixture-of-Experts Llama variant: the port of
:mod:`torchx_tpu.models.moe`, on one card and under a mesh.

A Mixtral-style MoE FFN in the GShard/Switch **einsum dispatch** form, as
the JAX package writes it: top-k routing materialised as one-hot dispatch
and combine tensors with a fixed per-expert capacity per batch row, so
every shape is static. Tokens routed past their expert's capacity are
dropped (GShard semantics). The products are plain ``torch.einsum``
calls: the JAX package leaves them to XLA, and no Pallas kernel computes
them.

Expert parallelism: :func:`param_specs` shards the expert axis of the
expert weights over ``("ep", "tp")`` combined, as the JAX package does.
Tokens do not shard over ``ep``: the ranks of an expert group (``ep`` x
``tp``) hold the same rows, each routes all of them, dispatches them to
its own experts only and combines their outputs, and one sum over the
group gives every rank the layer's output (where the JAX package's XLA
places a token all-to-all, the port exchanges nothing before the sum).
Parameters keep the JAX layout leaf for leaf
(:mod:`torchx_tpu_torch.convert`): the dense model's leaves with
``w_gate``/``w_up`` ``[L, E, d, f]``, ``w_down`` ``[L, E, f, d]`` and a
router ``w_router`` ``[L, d, E]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from torchx_tpu_torch.models import llama
from torchx_tpu_torch.parallel import mesh as mesh_ops
from torchx_tpu_torch.parallel.mesh import EXPERT_AXES


@dataclasses.dataclass(frozen=True)
class MoEConfig(llama.LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    # Switch/GShard load-balancing auxiliary loss coefficient (0 disables)
    router_aux_coef: float = 0.01

    def param_count(self) -> int:
        """Exact parameter count (dense shapes + per-expert FFNs)."""
        dense = super().param_count()
        ffn = 3 * self.dim * self.ffn_dim
        return dense + self.n_layers * (
            (self.n_experts - 1) * ffn + self.dim * self.n_experts
        )

    def flops_per_token(self) -> float:
        """MoE FLOPs count only the top_k ACTIVE experts per token."""
        attn = 12 * self.n_layers * self.dim * self.max_seq
        return 6 * self.active_param_count() + attn

    def active_param_count(self) -> int:
        """Params touched per token (top_k experts): the MFU-relevant N."""
        ffn = 3 * self.dim * self.ffn_dim
        dense = super().param_count()
        return dense + self.n_layers * (
            (self.top_k - 1) * ffn + self.dim * self.n_experts
        )


def moe_tiny(**overrides: Any) -> MoEConfig:
    """Test/debug MoE config: runs anywhere in milliseconds."""
    defaults = dict(
        vocab_size=512,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_dim=128,
        max_seq=128,
        dtype=torch.float32,
        remat=False,
        n_experts=4,
        top_k=2,
    )
    defaults.update(overrides)
    return MoEConfig(**defaults)


def mixtral_8x7b_shape(**overrides: Any) -> MoEConfig:
    """Mixtral-8x7B architecture shape (for parity/scaling experiments)."""
    defaults = dict(
        vocab_size=32000,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=14336,
        n_experts=8,
        top_k=2,
        rope_theta=1e6,
    )
    defaults.update(overrides)
    return MoEConfig(**defaults)


CONFIGS = {"moe_tiny": moe_tiny, "mixtral_8x7b": mixtral_8x7b_shape}


# -- parameters ------------------------------------------------------------


def init_params(
    cfg: MoEConfig,
    generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> llama.Params:
    """Dense-llama params (:func:`llama.init_params`, which draws the
    expert-stacked FFN leaves and the router for a MoE config) from
    ``generator``, which must live on ``device``."""
    return llama.init_params(cfg, generator, device)


def param_specs(cfg: MoEConfig, pp: bool = False) -> llama.Params:
    """The dense model's specs (:func:`llama.dense_param_specs`) with the
    expert leaves' as the JAX package's ``moe.param_specs``: the router's
    model dimension over ``fsdp``, the expert axis over ``("ep", "tp")``
    combined (``tp`` splits the experts, not their ffn width), each
    expert's model dimension over ``fsdp``, and with ``pp`` the stacked
    layer axis over the pipeline stages."""
    layer = "pp" if pp else None
    specs = llama.dense_param_specs(cfg, pp=pp)
    layers = specs["layers"]
    layers["w_router"] = (layer, "fsdp", None)
    layers["w_gate"] = (layer, EXPERT_AXES, "fsdp", None)
    layers["w_up"] = (layer, EXPERT_AXES, "fsdp", None)
    layers["w_down"] = (layer, EXPERT_AXES, None, "fsdp")
    return specs


# -- MoE FFN ----------------------------------------------------------------


def moe_ffn(
    cfg: MoEConfig,
    layer: llama.Params,  # one layer's slice (with w_router/w_gate/w_up/w_down)
    x: torch.Tensor,  # [b, s, d]
    mesh: Any = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard einsum dispatch: route -> dispatch to capacity slots ->
    per-expert SwiGLU -> combine.

    Returns (output, aux): aux is the router-health vector
    ``[balance, entropy, overflow]`` (order of ``llama.AUX_*``): the
    Switch load-balancing term ``E * sum_e fraction_routed_e *
    mean_router_prob_e`` (scaled into the loss by ``router_aux_coef``),
    the mean router entropy over log(E), and the share of (token, choice)
    routings dropped for a full expert buffer; the last two carry no
    gradient.

    Under ``mesh``, ``x`` is this rank's rows (and, under ``sp``, its
    positions) and the expert leaves of ``layer`` this rank's experts
    (:meth:`Mesh.experts`): ``x`` enters them through
    :func:`~torchx_tpu_torch.parallel.mesh.copy_to_experts` and their
    combined output is summed over the expert group, so every rank of the
    group returns the whole output (:func:`route` for the rest)."""
    dispatch, combine, aux = route(cfg, layer, x, mesh)
    if mesh is not None:
        x = mesh_ops.copy_to_experts(x, mesh)
    # tokens -> expert capacity slots [b, E, C, d], and back, gate-weighted
    expert_in = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)
    expert_out = experts(layer, expert_in)
    out = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), expert_out)
    if mesh is not None:
        out = mesh_ops.reduce_from_experts(out, mesh)
    return out, aux


def route(
    cfg: MoEConfig, layer: llama.Params, x: torch.Tensor, mesh: Any = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router: -> (dispatch [b, s, E, C] 0/1, combine [b, s, E, C]
    gate-weighted, aux), both f32, with capacity ``max(1, int(cf * s * k /
    E))`` per batch row.

    Under ``mesh``, the router's results are the whole batch's, as the
    reference's under its mesh: ``s`` is the whole sequence's length and
    the slots of this rank's positions follow the earlier ``sp`` ranks'
    routings to each expert (:func:`~torchx_tpu_torch.parallel.mesh.earlier_sp_sum`),
    so that capacity and drops are the whole row's; the balance term's
    per-expert fractions and mean probabilities, the entropy and the
    overflow are averaged over the token group (``dp`` x ``fsdp`` x ``sp``)
    before use (a product of means is not the mean of the ranks'
    products). The dispatch and combine tensors hold this rank's experts
    only, and the gate weights enter the combine through
    :func:`~torchx_tpu_torch.parallel.mesh.copy_to_experts`: the router
    is replicated over the expert group, and each rank's combine gives its
    experts' part of their gradient."""
    b, s, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    sp = mesh.sizes["sp"] if mesh is not None else 1
    capacity = max(1, int(cfg.capacity_factor * s * sp * k / E))

    # f32 logits: exact products of the inputs, f32 sums
    router_logits = x.float() @ layer["w_router"].float()  # [b, s, E]
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # [b, s, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    choice_oh = F.one_hot(gate_idx, E).float()  # [b, s, k, E]
    # position of each (token, choice) in its expert's buffer: cumsum over
    # the flattened (s, k) axis, per (b, E)
    flat = choice_oh.reshape(b, s * k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    if sp > 1:  # after the earlier sp ranks' positions of the row
        pos = pos + mesh_ops.earlier_sp_sum(flat.sum(dim=1), mesh)[:, None, :]
    pos = (pos * flat).sum(-1).reshape(b, s, k).to(torch.int64)
    within = pos < capacity
    # jax.nn.one_hot of an out-of-range position is all zeros; F.one_hot
    # refuses it, so clamp and let ``within`` zero the row
    pos_oh = F.one_hot(pos.clamp(max=capacity - 1), capacity).float() * within[..., None]

    mine = choice_oh
    if mesh is not None:  # this rank's experts
        gate_vals = mesh_ops.copy_to_experts(gate_vals, mesh)
        mine = choice_oh[..., mesh.experts(E)]
    dispatch = torch.einsum("bske,bskc->bsec", mine, pos_oh)
    combine = torch.einsum("bske,bskc,bsk->bsec", mine, pos_oh, gate_vals)

    # load balance: fraction of top-1 routings per expert x mean router
    # probability per expert (Switch Transformer eq. 4-6)
    top1_oh = choice_oh[:, :, 0, :]  # [b, s, E]
    frac_routed, mean_prob = top1_oh.mean(dim=(0, 1)), probs.mean(dim=(0, 1))
    if mesh is not None:
        frac_routed = mesh_ops.group_mean(frac_routed, mesh.token_group)
        mean_prob = mesh_ops.group_mean(mean_prob, mesh.token_group)
    balance = E * torch.sum(frac_routed * mean_prob)
    with torch.no_grad():  # health metrics only
        p_safe = torch.clamp(probs, min=1e-9)
        health = torch.stack([(-(p_safe * torch.log(p_safe)).sum(-1).mean()),
                              within.float().mean()])
        if mesh is not None:
            health = mesh_ops.group_mean(health, mesh.token_group)
        entropy = health[0] / math.log(float(E))
        overflow = 1.0 - health[1]
    return dispatch, combine, torch.stack([balance, entropy, overflow])


def experts(layer: llama.Params, expert_in: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU over the capacity slots: [b, E, C, d] -> [b, E, C,
    d], the expert axis a batch axis of each product."""
    gate = F.silu(torch.einsum("becd,edf->becf", expert_in, layer["w_gate"]))
    up = torch.einsum("becd,edf->becf", expert_in, layer["w_up"])
    return torch.einsum("becf,efd->becd", gate * up, layer["w_down"])


# -- model glue -------------------------------------------------------------
# llama.ffn dispatches to moe_ffn when the config carries n_experts;
# forward/loss_fn are re-exported so MoE callers depend only on this module.


def forward(params: llama.Params, tokens: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Logits for a MoE config (the shared llama forward dispatches to the
    expert FFN when the config carries experts)."""
    return llama.forward(params, tokens, cfg)


def loss_fn(
    params: llama.Params, batch: dict[str, torch.Tensor], cfg: MoEConfig
) -> torch.Tensor:
    """Next-token CE + the router balancing aux term."""
    return llama.loss_fn(params, batch, cfg)
