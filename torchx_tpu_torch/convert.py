"""Parameters (and training state) of the JAX package's Llama, as numpy
arrays, to the port's.

Both packages keep one layout, so the conversion is leaf by leaf and
changes no axis: layer weights stacked on a leading ``L`` axis, matrices
``[in, out]`` applied as ``x @ W`` (not ``nn.Linear``'s ``[out, in]``), and
no ``lm_head`` under ``tie_embeddings`` (the head is ``embed.T``). A MoE
config's tree (:mod:`torchx_tpu_torch.models.moe`) has the router
``w_router`` [L, d, E] and expert-stacked ``w_gate``/``w_up`` [L, E, d, f]
and ``w_down`` [L, E, f, d] in place of the dense FFN leaves. A tree of
weight-only int8 (``quantize_params`` of either package) holds ``{"q":
int8, "scale": f32}`` records in place of its projection matrices, and
converts as it is (the records keep their dtypes). The caller turns the
JAX arrays into numpy (``jax.tree.map(np.asarray, ...)``), so this module
imports no JAX.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from torchx_tpu_torch.models.llama import LlamaConfig, Params
from torchx_tpu_torch.ops.quant import _QUANT_KEYS

_LAYER_SHAPES = {
    "attn_norm": lambda c: (c.dim,),
    "wq": lambda c: (c.dim, c.n_heads * c.head_dim),
    "wk": lambda c: (c.dim, c.n_kv_heads * c.head_dim),
    "wv": lambda c: (c.dim, c.n_kv_heads * c.head_dim),
    "wo": lambda c: (c.n_heads * c.head_dim, c.dim),
    "mlp_norm": lambda c: (c.dim,),
    "w_gate": lambda c: (c.dim, c.ffn_dim),
    "w_up": lambda c: (c.dim, c.ffn_dim),
    "w_down": lambda c: (c.ffn_dim, c.dim),
}

#: A MoE config's FFN leaves (per layer), which replace the dense ones.
_MOE_LAYER_SHAPES = {
    "w_router": lambda c: (c.dim, c.n_experts),
    "w_gate": lambda c: (c.n_experts, c.dim, c.ffn_dim),
    "w_up": lambda c: (c.n_experts, c.dim, c.ffn_dim),
    "w_down": lambda c: (c.n_experts, c.ffn_dim, c.dim),
}


def _quantized_shape(key: str, shape: tuple) -> Any:
    """A projection's ``{"q", "scale"}`` shapes under ``quantize_params``
    (a matrix or a layer stack of one; expert stacks stay float)."""
    if key not in _QUANT_KEYS or len(shape) not in (2, 3):
        return shape
    return {"q": shape, "scale": (*shape[:-2], 1, shape[-1])}


def expected_shapes(cfg: LlamaConfig, quantized: bool = False) -> dict[str, Any]:
    """The parameter tree's shapes for ``cfg`` (``init_params``' layout);
    with ``quantized``, those of its ``quantize_params`` tree."""
    layer_shapes = dict(_LAYER_SHAPES)
    if getattr(cfg, "n_experts", 0):
        layer_shapes.update(_MOE_LAYER_SHAPES)
    shapes: dict[str, Any] = {
        "embed": (cfg.vocab_size, cfg.dim),
        "layers": {k: (cfg.n_layers, *f(cfg)) for k, f in layer_shapes.items()},
        "final_norm": (cfg.dim,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.dim, cfg.vocab_size)
    if quantized:
        shapes["layers"] = {k: _quantized_shape(k, v) for k, v in shapes["layers"].items()}
        shapes.update({k: _quantized_shape(k, v) for k, v in shapes.items() if k != "layers"})
    return shapes


def _is_record(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def _shapes(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _shapes(v) for k, v in node.items()}
    return tuple(np.shape(node))


def _to_tensor(arr: Any, device, dtype) -> torch.Tensor:  # noqa: ANN001
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: upcast exactly, then back
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(
    tree: dict[str, Any],
    cfg: Optional[LlamaConfig] = None,
    device: torch.device | str = "cpu",
    dtype: Optional[torch.dtype] = None,
    requires_grad: bool = True,
) -> Params:
    """JAX ``init_params`` tree of numpy arrays -> the port's params.

    With ``cfg``, every leaf's shape and the presence of ``lm_head`` are
    checked against it. ``dtype`` (default: keep each array's) casts every
    float leaf; the int8 records of a quantized tree keep their dtypes and
    never require grad. The returned leaves require grad for training;
    serving takes ``requires_grad=False`` (the engine refuses leaves that
    require grad)."""
    if cfg is not None:
        quantized = any(_is_record(v) for v in (*tree.values(), *tree["layers"].values()))
        want = expected_shapes(cfg, quantized)
        if set(tree) != set(want) or set(tree["layers"]) != set(want["layers"]):
            raise ValueError(
                f"param tree keys {sorted(tree)} / {sorted(tree['layers'])} do not"
                f" match the config's {sorted(want)} (tie_embeddings="
                f"{cfg.tie_embeddings})"
            )
        got = _shapes(tree)
        if got != want:
            raise ValueError(f"param shapes {got} do not match the config's {want}")

    def conv(node: Any) -> Any:
        if _is_record(node):
            return {k: _to_tensor(v, device, None) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, device, dtype).requires_grad_(requires_grad)

    return conv(tree)


def _find_adam_state(node: Any) -> Any:
    """The optax ``ScaleByAdamState`` (fields count, mu, nu) inside an
    optimizer state of nested tuples, or None."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def train_state_from_jax(
    state: Any,
    cfg: Optional[LlamaConfig] = None,
    device: torch.device | str = "cpu",
) -> dict[str, Any]:
    """A JAX trainer's ``TrainState`` of numpy leaves
    (``jax.tree.map(np.asarray, state)``) -> the port's training state:
    ``{"params", "mu", "nu", "count", "step"}``, where ``params`` requires
    grad, ``mu`` and ``nu`` (AdamW's moments) are trees of the params'
    layout, and ``count`` (the optimizer's update count) and ``step`` are
    ints. Load ``mu``, ``nu`` and ``count`` into the port's ``AdamW`` and
    the run continues where the JAX one stopped."""
    adam = _find_adam_state(state.opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam moments (count, mu, nu)")
    return {
        "params": params_from_jax(state.params, cfg, device),
        "mu": params_from_jax(adam.mu, cfg, device, requires_grad=False),
        "nu": params_from_jax(adam.nu, cfg, device, requires_grad=False),
        "count": int(np.asarray(adam.count)),
        "step": int(np.asarray(state.step)),
    }
