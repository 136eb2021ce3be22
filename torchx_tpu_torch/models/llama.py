"""Llama-3-family decoder in PyTorch: the port of
:mod:`torchx_tpu.models.llama`, dense and (with a :mod:`.moe` config) with
the GShard MoE FFN.

Parameters keep the JAX package's layout, so :mod:`torchx_tpu_torch.convert`
maps one onto the other leaf by leaf: a dict of tensors with the layer
weights stacked on a leading ``L`` axis, matrices ``[in, out]`` applied as
``x @ W``, and no ``lm_head`` under ``tie_embeddings``. bf16 parameters and
activations, f32 softmax, norms and cross-entropy reductions.

``remat=True`` recomputes each layer in the backward pass
(``torch.utils.checkpoint`` per layer) under ``remat_policy``, the JAX
package's policies: ``"full"`` saves each layer's input only; ``"dots"``
also saves the products with no batch dimensions (``mm``, ``addmm`` and
the int8 dot's ``_int_mm``: the q/k/v, ``wo``, gate and up projections
and a MoE router's logits; the attention logits, the MoE dispatch,
combine and expert products are batched and recomputed) through a
selective-checkpoint policy; ``"dots_attn"`` also saves the attention
operator's outputs (the flash forward's ``o`` and ``lse``, or the plain
path's ``attn_out``). Everything else, the collectives included, runs
again in the recompute, so every rank keeps one collective order.
``"auto"`` is resolved before the forward
(:func:`torchx_tpu_torch.parallel.remat_auto.choose_remat_policy`). The loss
computes cross-entropy in sequence chunks (``loss_chunk``), each recomputed
in the backward, so only ``[batch, chunk, vocab]`` logits ever exist, stored
in bf16 unless ``ce_f32_logits``.

``int8_matmuls`` routes the layer projections through the int8 training
dot (:func:`torchx_tpu_torch.ops.quant.maybe_matmul`; ``int8_scope``
``"all"`` or ``"ffn"``), as the JAX package routes them through AQT. A
layer weight may also be a quantized ``{"q", "scale"}`` record of weight-only
serving (:func:`~torchx_tpu_torch.ops.quant.quantize_params`): the same
call takes it.

Under a :class:`~torchx_tpu_torch.parallel.mesh.Mesh` (``mesh=`` of
:func:`forward_features` and :func:`loss_and_aux`) the parameters are this
rank's shards (:func:`param_specs`, :func:`shard_params`, the JAX
package's layout) and the tokens its rows of the batch:

* ``fsdp``: each layer gathers its weights inside the checkpointed layer,
  so the remat recompute gathers them again and no more than one layer's
  whole weights live at a time (ZeRO-3); the embedding is gathered once a
  step;
* ``tp`` (Megatron): each rank computes ``n_heads / tp`` query heads,
  ``n_kv_heads / tp`` KV heads and ``ffn_dim / tp`` ffn columns, with one
  all-reduce after ``wo`` and one after ``w_down``; the logits stay
  vocab-sharded, and the cross-entropy reduces its logsumexp and target
  logit over ``tp``, so ``[b, c, vocab]`` logits never exist on one rank;
* ``sp``: the residual stream, the norms and the cross-entropy run on this
  rank's positions (RoPE at their global positions); attention gathers
  q, k and v over ``sp`` and runs on the whole sequence, as the JAX
  package's attention does under a mesh, then keeps this rank's rows; with
  ``use_ring_attention`` it runs on this rank's query block instead, the
  K/V blocks passed around the ``sp`` ring
  (:mod:`torchx_tpu_torch.ops.ring_attention`), so that no rank holds the
  whole sequence's q, k and v;
* ``ep`` (a MoE config): each rank of the expert group (``ep`` x ``tp``)
  computes its ``n_experts / (ep * tp)`` experts on the group's tokens,
  and their output is summed over the group (:mod:`.moe`); attention keeps
  the dense ``tp`` split. A dense config is replicated over ``ep``;
* ``pp``: each stage holds ``n_layers / pp`` layers (``param_specs(cfg,
  pp=True)``) and runs them on the embedding's output in ``pp_microbatches``
  microbatches (the reference's ``gcd(2 * pp, rows)`` when 0), GPipe
  (:mod:`torchx_tpu_torch.parallel.pipeline`); the embedding, the final
  norm and the head stay outside the pipeline, whole on every stage, which
  all compute the loss on the last stage's outputs.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Any, Iterator

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from torchx_tpu_torch.ops.attention import attention
from torchx_tpu_torch.ops.fused import flash_attention, rms_norm_residual
from torchx_tpu_torch.ops.norms import rms_norm
from torchx_tpu_torch.ops.quant import maybe_matmul
from torchx_tpu_torch.ops.ring_attention import ring_attention
from torchx_tpu_torch.ops.rope import apply_rope, rope_frequencies
from torchx_tpu_torch.parallel import mesh as mesh_ops
from torchx_tpu_torch.parallel.pipeline import (
    auto_microbatches, pipeline_apply, reference_microbatches,
)

Params = dict[str, Any]

# Layout of the router-health aux vector (the JAX package's names); the
# dense model's is all zeros.
AUX_BALANCE, AUX_ENTROPY, AUX_OVERFLOW = 0, 1, 2
AUX_LEN = 3

KERNELS = ("reference", "cuda")

#: The remat policies a layer runs under; ``"auto"`` resolves to one of
#: them before the forward (the JAX package's ``_remat``).
REMAT_POLICIES = ("full", "dots", "dots_attn")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    remat: bool = True
    # what each remat'd layer saves: "full" | "dots" | "dots_attn", or
    # "auto" (resolved by the trainer before the forward)
    remat_policy: str = "full"
    attn_impl: str = "auto"  # auto | xla | flash (ops/attention.py)
    # the flash kernels' tile (ops/fused.py fit_tile): query and kv rows,
    # 0 = the card's default table
    attn_block_q: int = 0
    attn_block_kv: int = 0
    # causal attention over sp by ring attention (ops/ring_attention.py) in
    # place of the sequence gather; inert without sp
    use_ring_attention: bool = False
    # cross-entropy in sequence chunks of this size; 0 disables chunking
    loss_chunk: int = 512
    # int8 training matmuls for the layer projections (ops/quant.py: AQT's
    # numerics, forward and backward in int8, straight-through gradient);
    # the master weights stay in the model dtype
    int8_matmuls: bool = False
    # which projections int8_matmuls quantizes: "all" (attention + FFN) or
    # "ffn" (gate/up/down only)
    int8_scope: str = "all"
    ce_f32_logits: bool = False
    # microbatches of the pipeline on meshes with pp > 1; 0: the
    # reference's gcd(2 * pp, a rank's rows)
    pp_microbatches: int = 0
    # "reference" keeps the plain ops; "cuda" routes attention and the
    # residual-add + RMSNorm through the hand-written kernels (ops/fused.py)
    kernels: str = "reference"

    def __post_init__(self) -> None:
        if self.int8_scope not in ("all", "ffn"):
            raise ValueError(
                f"int8_scope must be 'all' or 'ffn', got {self.int8_scope!r}"
            )
        if self.kernels not in KERNELS:
            raise ValueError(f"kernels must be one of {KERNELS}, got {self.kernels!r}")
        if self.attn_block_q < 0 or self.attn_block_kv < 0:
            raise ValueError(
                "attn_block_q and attn_block_kv must be >= 0 (0: the card's default),"
                f" got {self.attn_block_q}, {self.attn_block_kv}"
            )
        if self.remat_policy not in REMAT_POLICIES + ("auto",):
            raise ValueError(
                f"remat_policy must be one of {REMAT_POLICIES + ('auto',)},"
                f" got {self.remat_policy!r}"
            )

    @property
    def head_dim(self) -> int:
        """Per-head projection width (dim / n_heads)."""
        return self.dim // self.n_heads

    def flops_per_token(self) -> float:
        """Training FLOPs/token (fwd+bwd), 6N + attention quadratic term
        (the JAX package's formula)."""
        return 6 * self.param_count() + 12 * self.n_layers * self.dim * self.max_seq

    def param_count(self) -> int:
        """Exact parameter count for this shape (layers + embeddings)."""
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        hd = self.head_dim
        per_layer = (
            d * self.n_heads * hd
            + 2 * d * self.n_kv_heads * hd
            + self.n_heads * hd * d
            + 3 * d * f
            + 2 * d
        )
        total = self.n_layers * per_layer + v * d + d
        if not self.tie_embeddings:
            total += d * v
        return total


# -- presets ---------------------------------------------------------------


def llama3_8b(**overrides: Any) -> LlamaConfig:
    """Llama-3-8B (the config defaults: 32L/4096d/32h/8kv/128k vocab)."""
    return LlamaConfig(**overrides)


def llama3_1b(**overrides: Any) -> LlamaConfig:
    """Llama-3.2-1B shape (tied embeddings).

    attn_block_q/kv 64/64 come from the H100 sweep (``chip_smoke.py
    --phases build,sweep`` at b 4, s 2048, 32/8 heads, head_dim 64, causal,
    bf16; H100 80GB HBM3, 700 W): each of the three wgmma flash kernels is
    fastest at 64/64, forward 0.2783 ms, dq 0.2718, dk/dv 0.5195 against
    0.3043 / 0.3127 / 0.5545 at their first tiles (128/128, 128/128,
    64/128), 21.57 ms of flash a step (32 forwards under full remat, 16 of
    each backward) against 23.61.
    """
    defaults = dict(
        dim=2048,
        n_layers=16,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=8192,
        tie_embeddings=True,
        attn_block_q=64,
        attn_block_kv=64,
    )
    defaults.update(overrides)
    return LlamaConfig(**defaults)


def llama_tiny(**overrides: Any) -> LlamaConfig:
    """Test/debug config: runs on anything in milliseconds."""
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
    )
    defaults.update(overrides)
    return LlamaConfig(**defaults)


CONFIGS = {
    "llama3_8b": llama3_8b,
    "llama3_1b": llama3_1b,
    "tiny": llama_tiny,
}


def all_configs() -> dict:
    """Dense llama presets plus the MoE family (models/moe.py), as the JAX
    trainer's ``all_configs``."""
    from torchx_tpu_torch.models import moe

    return {**CONFIGS, **moe.CONFIGS}


def get_config(name: str) -> LlamaConfig:
    """The preset ``name``, dense or MoE."""
    configs = all_configs()
    if name not in configs:
        raise ValueError(f"unknown config {name!r}; have {sorted(configs)}")
    return configs[name]()


# -- parameters ------------------------------------------------------------


def init_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> Params:
    """Scaled-normal init (N(0, 1) * in_dim**-0.5, drawn in f32 and cast to
    ``cfg.dtype``); layer params stacked on a leading axis. Leaves require
    grad. ``generator`` must live on ``device``.

    A MoE config (``n_experts``) gets the router ``w_router`` [L, d, E] and
    expert-stacked FFN leaves ``w_gate``/``w_up`` [L, E, d, f] and
    ``w_down`` [L, E, f, d] in place of the dense FFN, each expert's matrix
    drawn on its own, so that no f32 draw holds a whole leaf (Mixtral's
    ``w_gate`` at 16 layers would take 30 GB)."""
    d, f = cfg.dim, cfg.ffn_dim
    hd, h, kvh, L = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers

    def normal(shape, in_dim):  # noqa: ANN001, ANN202
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (x * in_dim**-0.5).to(cfg.dtype)

    def normal_per_matrix(shape, in_dim):  # noqa: ANN001, ANN202
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        for mat in out.view(-1, *shape[-2:]):
            mat.copy_(normal(shape[-2:], in_dim))
        return out

    def ones(shape):  # noqa: ANN001, ANN202
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    layers = {
        "attn_norm": ones((L, d)),
        "wq": normal((L, d, h * hd), d),
        "wk": normal((L, d, kvh * hd), d),
        "wv": normal((L, d, kvh * hd), d),
        "wo": normal((L, h * hd, d), h * hd),
        "mlp_norm": ones((L, d)),
    }
    n_experts = getattr(cfg, "n_experts", 0)
    if n_experts:
        layers["w_router"] = normal((L, d, n_experts), d)
        layers["w_gate"] = normal_per_matrix((L, n_experts, d, f), d)
        layers["w_up"] = normal_per_matrix((L, n_experts, d, f), d)
        layers["w_down"] = normal_per_matrix((L, n_experts, f, d), f)
    else:
        layers["w_gate"] = normal((L, d, f), d)
        layers["w_up"] = normal((L, d, f), d)
        layers["w_down"] = normal((L, f, d), f)
    params: Params = {
        "embed": normal((cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    return params


def leaves(params: Params) -> list[torch.Tensor]:
    """The parameter tensors in the JAX pytree's order (dict keys sorted,
    depth first)."""
    return [t for _, t in named_leaves(params)]


def named_leaves(params: Params, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(dotted path, tensor)`` pairs in :func:`leaves`' order, such as
    ``("layers.wq", ...)``."""
    out = []
    for key in sorted(params):
        val = params[key]
        if isinstance(val, dict):
            out.extend(named_leaves(val, f"{prefix}{key}."))
        else:
            out.append((f"{prefix}{key}", val))
    return out


def unflatten(flat: dict[str, torch.Tensor]) -> Params:
    """Inverse of :func:`named_leaves`: dotted paths -> the nested tree."""
    tree: Params = {}
    for path, t in flat.items():
        *parents, key = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = t
    return tree


# -- sharding --------------------------------------------------------------


def param_specs(cfg: LlamaConfig, pp: bool = False) -> Params:
    """The tree of :func:`init_params` with, for each leaf, the mesh axes
    that shard each of its dimensions (None: not sharded), as the JAX
    package's ``param_specs`` through its ``model_fns``: the dense model's
    (:func:`dense_param_specs`), or for a MoE config ``moe.param_specs``.
    With ``pp`` the stacked layer axis shards over the pipeline stages."""
    if getattr(cfg, "n_experts", 0):
        from torchx_tpu_torch.models import moe

        return moe.param_specs(cfg, pp=pp)
    return dense_param_specs(cfg, pp=pp)


def mesh_param_specs(cfg: LlamaConfig, mesh: Any) -> Params:
    """:func:`param_specs` of ``mesh``: the layer axis over ``pp`` where the
    mesh has stages."""
    return param_specs(cfg, pp=mesh.sizes["pp"] > 1)


def dense_param_specs(cfg: LlamaConfig, pp: bool = False) -> Params:
    """The dense model's specs: ``fsdp`` shards the model dimension of
    every matrix (ZeRO-3), ``tp`` its heads or ffn dimension, ``pp`` (with
    ``pp``) the stacked layer axis; the norms are replicated."""
    layer = "pp" if pp else None
    specs: Params = {
        "embed": (None, "fsdp"),
        "layers": {
            "attn_norm": (layer, None),
            "wq": (layer, "fsdp", "tp"),
            "wk": (layer, "fsdp", "tp"),
            "wv": (layer, "fsdp", "tp"),
            "wo": (layer, "tp", "fsdp"),
            "mlp_norm": (layer, None),
            "w_gate": (layer, "fsdp", "tp"),
            "w_up": (layer, "fsdp", "tp"),
            "w_down": (layer, "tp", "fsdp"),
        },
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("fsdp", "tp")
    return specs


def shard_params(params: Params, cfg: LlamaConfig, mesh: Any) -> Params:
    """This rank's shard of every leaf of the whole tree ``params`` under
    :func:`mesh_param_specs` (fresh tensors that require grad, as the
    leaves of :func:`init_params`): rank ``r`` holds what JAX's
    ``shard_params`` puts on device ``r``."""
    from torchx_tpu_torch.parallel.mesh import shard

    specs = dict(named_leaves(mesh_param_specs(cfg, mesh)))
    out = unflatten({
        name: shard(p.detach(), specs[name], mesh) for name, p in named_leaves(params)
    })
    for leaf in leaves(out):
        leaf.requires_grad_(True)
    return out


# -- remat policies --------------------------------------------------------

#: Products with no batch dimensions: what ``"dots"`` saves, as JAX's
#: ``dots_with_no_batch_dims_saveable`` (the int8 dot's int32 product too).
#: Batched products (``bmm``) are recomputed.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten._int_mm.default)
#: What ``"dots_attn"`` adds: the attention operator's outputs.
_ATTN_OPS = (torch.ops.tpx.flash_fwd.default, torch.ops.tpx.attn_out.default)

_UNSAVED = contextvars.ContextVar("tpx_remat_unsaved", default=False)


@contextlib.contextmanager
def _unsaved() -> Iterator[None]:
    """Products inside run again in the recompute under every policy: for
    one whose output the backward never reads (the FFN's down projection,
    consumed by the residual add), which JAX's checkpoint drops as a
    residual while a selective checkpoint would keep every saved op's
    output until the recompute."""
    token = _UNSAVED.set(True)
    try:
        yield
    finally:
        _UNSAVED.reset(token)


def _policy(saved: frozenset, ctx: Any, op: Any, *args: Any, **kwargs: Any) -> CheckpointPolicy:
    if op in saved and not _UNSAVED.get():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_kwargs(cfg: LlamaConfig) -> dict[str, Any]:
    """``torch.utils.checkpoint`` keywords of ``cfg.remat_policy``: none for
    ``"full"``, a selective-checkpoint policy for ``"dots"`` and
    ``"dots_attn"``. ``"auto"`` raises: it is resolved before the forward."""
    if cfg.remat_policy == "auto":
        raise ValueError(
            "remat_policy='auto' must be resolved before tracing — call"
            " torchx_tpu_torch.parallel.remat_auto.choose_remat_policy"
            " (the trainer does this at launch)"
        )
    if cfg.remat_policy == "full":
        return {}
    saved = frozenset(_DOT_OPS + (_ATTN_OPS if cfg.remat_policy == "dots_attn" else ()))
    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, functools.partial(_policy, saved))}


# -- forward ---------------------------------------------------------------


def ffn(
    cfg: LlamaConfig, layer: Params, mlp_in: torch.Tensor, mesh: Any = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The FFN half of a layer: dense SwiGLU, or the GShard MoE dispatch
    when the config carries experts (under ``mesh``, this rank's experts,
    their output summed over the expert group: ``moe.moe_ffn``). -> (down,
    aux). Shared by the training forward and the decode paths, so the two
    never diverge."""
    if getattr(cfg, "n_experts", 0):
        if cfg.int8_matmuls:
            import warnings

            scope = cfg.int8_scope
            warnings.warn(
                "int8_matmuls does not cover the MoE expert einsums"
                " (expert-stacked weights need a grouped AQT einsum); "
                + (
                    "only the attention projections quantize"
                    if scope == "all"
                    else "with int8_scope='ffn' NOTHING quantizes on a MoE"
                    " config — the flag is a no-op here"
                ),
                stacklevel=2,
            )
        from torchx_tpu_torch.models.moe import moe_ffn

        return moe_ffn(cfg, layer, mlp_in, mesh)
    i8 = cfg.int8_matmuls
    gate = F.silu(maybe_matmul(mlp_in, layer["w_gate"], int8_training=i8))
    up = maybe_matmul(mlp_in, layer["w_up"], int8_training=i8)
    with _unsaved():
        down = maybe_matmul(gate * up, layer["w_down"], int8_training=i8)
    return down, torch.zeros((AUX_LEN,), dtype=torch.float32, device=mlp_in.device)


_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")


def _layer_keys(cfg: LlamaConfig) -> tuple[str, ...]:
    """The stacked layer leaves a layer reads: a MoE config adds its
    router."""
    return _LAYER_KEYS + (("w_router",) if getattr(cfg, "n_experts", 0) else ())


def _layer(
    cfg: LlamaConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    x: torch.Tensor,  # [b, s, d]
    *weights: torch.Tensor,  # one layer's slice, in _layer_keys order
    mesh: Any = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (x, aux). Under ``mesh`` the weights are this rank's ``tp``
    blocks and experts (whole over ``fsdp``), ``x`` its rows and positions
    of the sequence and ``cos``/``sin`` theirs."""
    layer = dict(zip(_layer_keys(cfg), weights))
    b, s, _ = x.shape
    tp = mesh.sizes["tp"] if mesh is not None else 1
    sp = mesh.sizes["sp"] if mesh is not None else 1
    h, kvh, hd = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim

    i8_attn = cfg.int8_matmuls and cfg.int8_scope == "all"
    attn_in = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    if tp > 1:
        attn_in = mesh_ops.copy_to_tp(attn_in, mesh)
    q = maybe_matmul(attn_in, layer["wq"], int8_training=i8_attn).reshape(b, s, h, hd)
    k = maybe_matmul(attn_in, layer["wk"], int8_training=i8_attn).reshape(b, s, kvh, hd)
    v = maybe_matmul(attn_in, layer["wv"], int8_training=i8_attn).reshape(b, s, kvh, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if sp > 1 and cfg.use_ring_attention:
        # this rank's query block against every K/V block of the ring
        attn_out = ring_attention(q, k, v, mesh)
    else:
        if sp > 1:
            # the whole sequence's q, k and v in one gather (heads are the
            # same on every sp rank)
            qkv = mesh_ops.gather_sequence(torch.cat([q, k, v], dim=2), 1, mesh)
            q, k, v = qkv.split([h, kvh, kvh], dim=2)
        attn_out = None
        if cfg.kernels != "reference":
            # None when the shape gate fails: the plain path below
            attn_out = flash_attention(q, k, v, causal=True, kernels=cfg.kernels,
                                       block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
        if attn_out is None:
            attn_out = attention(q, k, v, causal=True, impl=cfg.attn_impl,
                                 block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
        if sp > 1:
            attn_out = mesh_ops.sequence_block(attn_out, 1, mesh)
    attn_out = maybe_matmul(attn_out.reshape(b, s, h * hd), layer["wo"], int8_training=i8_attn)
    if tp > 1:
        attn_out = mesh_ops.reduce_from_tp(attn_out, mesh)
    if cfg.kernels != "reference":
        # fused residual-add + RMSNorm: one pass yields the mlp input and
        # the continued stream (plain op sequence when the gate fails)
        mlp_in, x = rms_norm_residual(
            x, attn_out, layer["mlp_norm"], cfg.norm_eps, kernels=cfg.kernels
        )
    else:
        x = x + attn_out
        mlp_in = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    # a dense FFN is column- then row-parallel over tp; a MoE FFN splits its
    # experts over ep x tp and sums over that group itself (moe.moe_ffn)
    dense_tp = tp > 1 and not getattr(cfg, "n_experts", 0)
    if dense_tp:
        mlp_in = mesh_ops.copy_to_tp(mlp_in, mesh)
    down, aux = ffn(cfg, layer, mlp_in, mesh)
    if dense_tp:
        down = mesh_ops.reduce_from_tp(down, mesh)
    return x + down, aux


def _sharded_layer(
    mesh: Any, specs: tuple, cfg: LlamaConfig, cos: torch.Tensor, sin: torch.Tensor,
    x: torch.Tensor, *shards: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_layer` on one layer's weights gathered over ``fsdp`` from
    this rank's shards (``specs``: each shard's spec, the layer axis
    dropped; ``tp`` blocks and experts stay local)."""
    return _layer(cfg, cos, sin, x, *(mesh.unshard(w, sp) for w, sp in zip(shards, specs)),
                  mesh=mesh)


def _unshard_top(params: Params, cfg: LlamaConfig, mesh: Any) -> Params:
    """``params`` with the leaves outside the layers whole over ``fsdp``:
    the embedding (the tied head too) and an untied head (its ``tp`` block)
    gathered once, the final norm marked replicated."""
    specs = param_specs(cfg)
    out = dict(params)
    for key in ("embed", "lm_head", "final_norm"):
        if key in params:
            out[key] = mesh.unshard(params[key], specs[key])
    return out


def forward_features(
    params: Params,
    tokens: torch.Tensor,  # [b, s] int
    cfg: LlamaConfig,
    mesh: Any = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (final-norm hidden states [b, s, dim], router-health aux).

    With ``mesh``, the layer leaves of ``params`` are this rank's shards,
    which each layer gathers inside the (checkpointed) layer; the leaves
    outside the layers are whole (:func:`_unshard_top`); ``tokens`` are this
    rank's rows and, under ``sp``, its positions of a sequence ``sp`` times
    as long, whose hidden states it returns. Under ``pp`` the layers are
    this stage's, pipelined over the stages, and every stage returns the
    last stage's hidden states; the aux vector is then the reference's
    pipelined one: summed over the layers, averaged over the microbatches,
    its entropy and overflow divided by ``n_layers``."""
    x = F.embedding(tokens, params["embed"]).to(cfg.dtype)
    s = x.shape[1]
    sp = mesh.sizes["sp"] if mesh is not None else 1
    # RoPE at the global positions of this rank's block
    cos, sin = rope_frequencies(cfg.head_dim, s * sp, cfg.rope_theta, device=x.device)
    if sp > 1:
        pos = mesh.positions(s * sp)
        cos, sin = cos[pos], sin[pos]
    keys = _layer_keys(cfg)
    layer_fn = _layer
    if mesh is not None:
        specs = tuple(param_specs(cfg)["layers"][key][1:] for key in keys)
        layer_fn = functools.partial(_sharded_layer, mesh, specs)
    remat = remat_kwargs(cfg) if cfg.remat else {}

    def body(h: torch.Tensor, weights: list) -> tuple[torch.Tensor, torch.Tensor]:
        if cfg.remat:
            return checkpoint(layer_fn, cfg, cos, sin, h, *weights, use_reentrant=False,
                              **remat)
        return layer_fn(cfg, cos, sin, h, *weights)

    if mesh is not None and mesh.sizes["pp"] > 1:
        n_micro = auto_microbatches(cfg.pp_microbatches, mesh.sizes["pp"], x.shape[0])
        x, aux = pipeline_apply(body, [params["layers"][key] for key in keys], x, mesh,
                                n_micro, with_aux=True)
        # stages sum the aux over their layers; the entropy and overflow are
        # per-layer means, so the layer count comes back out
        aux_total = torch.stack([aux[AUX_BALANCE], aux[AUX_ENTROPY] / cfg.n_layers,
                                 aux[AUX_OVERFLOW] / cfg.n_layers])
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total
    # one unbind per stacked leaf: the backward stacks the layer grads once
    per_layer = [params["layers"][key].unbind(0) for key in keys]
    auxes = []
    for i in range(cfg.n_layers):
        x, aux = body(x, [w[i] for w in per_layer])
        auxes.append(aux)
    aux = torch.stack(auxes)
    aux_total = torch.stack(
        [aux[:, AUX_BALANCE].sum(), aux[:, AUX_ENTROPY].mean(), aux[:, AUX_OVERFLOW].mean()]
    )
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total


def lm_head(params: Params, cfg: LlamaConfig) -> torch.Tensor:
    """[dim, vocab] output projection (the embedding transposed when
    tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """-> logits [b, s, vocab] float32 (full materialization — the loss
    never builds this tensor)."""
    x, _ = forward_features(params, tokens, cfg)
    return x.float() @ lm_head(params, cfg).float()


def _token_nll(
    x: torch.Tensor,  # [b, c, d] hidden states
    head: torch.Tensor,  # [d, v], or this rank's [d, v / tp] block under tp
    targets: torch.Tensor,  # [b, c]
    f32_logits: bool = False,
    mesh: Any = None,
) -> torch.Tensor:
    """-> per-token negative log-likelihood [b, c] float32, as
    ``logsumexp(logits) - logits[target]``; logits stored in the model dtype
    unless ``f32_logits`` (f32 products and sums either way: an f32 matmul
    of the upcast operands is exact for bf16 inputs).

    Under a ``mesh`` with ``tp`` > 1, ``head`` is this rank's vocab block:
    the logsumexp takes its maximum and its sum of exponentials over
    ``tp``, the target logit comes from the rank whose block holds it, and
    every ``tp`` rank returns the whole vocabulary's values."""
    logits = x.float() @ head.float() if f32_logits else x @ head
    lf = logits.float()
    if mesh is None or mesh.sizes["tp"] == 1:
        lse = torch.logsumexp(lf, dim=-1)
        tgt = torch.gather(lf, -1, targets[..., None].long())[..., 0]
        return lse - tgt
    v = lf.shape[-1]
    lo = mesh.coords["tp"] * v
    m = mesh_ops.max_over_tp(lf.amax(dim=-1), mesh)
    sumexp = mesh_ops.reduce_from_tp(torch.exp(lf - m[..., None]).sum(dim=-1), mesh)
    local = targets.long() - lo
    mine = (local >= 0) & (local < v)
    tgt = torch.gather(lf, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    tgt = mesh_ops.reduce_from_tp(torch.where(mine, tgt, 0.0), mesh)
    return m + torch.log(sumexp) - tgt


def _chunk_nll_sum(x_c, head, t_c, f32, m_c=None, mesh=None):  # noqa: ANN001, ANN202
    nll = _token_nll(x_c, head, t_c, f32, mesh)
    return (nll * m_c).sum() if m_c is not None else nll.sum()


def loss_fn(params: Params, batch: dict[str, torch.Tensor], cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy loss (see :func:`loss_and_aux`)."""
    return loss_and_aux(params, batch, cfg)[0]


def _global_count(m: torch.Tensor, mesh: Any) -> torch.Tensor:
    """The kept targets of the whole batch: ``m.sum()`` summed over the
    ranks that split the batch's tokens (a constant of the graph)."""
    import torch.distributed as dist

    n = m.sum().detach()
    with mesh_ops.collective_range(mesh.token_group):
        dist.all_reduce(n, group=mesh.token_group)
    return n


def loss_and_aux(
    params: Params,
    batch: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    mesh: Any = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (loss, router-health aux vector). ``batch["tokens"]`` is
    [b, seq+1]: the model runs on ``tokens[:, :-1]``; an optional
    ``loss_mask`` weights the targets. The loss adds ``router_aux_coef``
    times the balance term (``aux[AUX_BALANCE]``, 0 for dense models).

    With ``mesh``, ``params`` are this rank's shards and ``batch`` its rows
    (whole sequences; under ``sp`` the rank computes its positions of
    them): the loss is this rank's share of the whole batch's mean (its
    mean over the ``dp * fsdp * sp`` ranks that split the tokens; with a
    mask, its sum over the whole batch's kept targets), so the shares
    summed over those ranks give the mean. ``tp`` ranks compute the same
    tokens and each returns the same share."""
    tokens = batch["tokens"]
    mask = batch.get("loss_mask")
    if (mesh is not None and getattr(cfg, "n_experts", 0) and mesh.sizes["pp"] > 1
            and mesh.data_size > 1):
        # the router's balance term is taken over a microbatch's rows of
        # every data rank, and is nonlinear in them: each rank computes its
        # block of the reference's microbatches (a dense loss sums the same
        # rows either way)
        n_micro = auto_microbatches(cfg.pp_microbatches, mesh.sizes["pp"], tokens.shape[0])
        tokens = reference_microbatches(tokens, mesh, n_micro)
        if mask is not None:
            mask = reference_microbatches(mask, mesh, n_micro)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    m = mask[:, 1:].float() if mask is not None else None
    if mesh is not None:
        params = _unshard_top(params, cfg, mesh)
        pos = mesh.positions(inputs.shape[1])
        inputs, targets = inputs[:, pos], targets[:, pos]
        if m is not None:
            m = m[:, pos]
    x, aux = forward_features(params, inputs, cfg, mesh)
    aux_term = getattr(cfg, "router_aux_coef", 0.0) * aux[AUX_BALANCE]
    head = lm_head(params, cfg)
    if mesh is not None and mesh.sizes["tp"] > 1:
        # the head is column-parallel over the vocabulary: each rank's block
        # gives its part of the hidden states' gradient
        x = mesh_ops.copy_to_tp(x, mesh)
        if cfg.tie_embeddings:  # whole on every tp rank: its vocab block
            head = mesh_ops.tp_block(head, 1, mesh)
    f32 = cfg.ce_f32_logits
    count = None  # the kept targets of the whole batch
    if m is not None:
        count = _global_count(m, mesh) if mesh is not None else m.sum()

    def mean_share(loss: torch.Tensor) -> torch.Tensor:
        # this rank's share of the mean over the ranks the tokens are split over
        return loss / mesh.token_size if mesh is not None else loss

    # every rank computes the whole batch's balance term (moe.route averages
    # its per-expert means over the token group): summed over the group, the
    # shares count it once
    aux_term = mean_share(aux_term)
    b, s = targets.shape
    chunk = cfg.loss_chunk
    if chunk and s % chunk == 0 and s > chunk:
        # chunks recomputed in the backward: only [b, chunk, vocab] logits
        # ever exist instead of [b, s, vocab]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(s // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            args = (x[:, sl], head, targets[:, sl], f32)
            if m is not None:
                args += (m[:, sl],)
            total = total + checkpoint(_chunk_nll_sum, *args, mesh=mesh, use_reentrant=False)
        if m is None:
            return mean_share(total / (b * s)) + aux_term, aux
        return total / torch.clamp(count, min=1.0) + aux_term, aux

    nll = _token_nll(x, head, targets, f32, mesh)
    if m is not None:
        return (nll * m).sum() / torch.clamp(count, min=1.0) + aux_term, aux
    return mean_share(nll.mean()) + aux_term, aux
