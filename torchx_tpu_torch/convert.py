"""Parameters of the JAX package's Llama, as numpy arrays, to the port's.

Both packages keep one layout, so the conversion is leaf by leaf and
changes no axis: layer weights stacked on a leading ``L`` axis, matrices
``[in, out]`` applied as ``x @ W`` (not ``nn.Linear``'s ``[out, in]``), and
no ``lm_head`` under ``tie_embeddings`` (the head is ``embed.T``). The
caller turns the JAX arrays into numpy (``jax.tree.map(np.asarray, ...)``),
so this module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from torchx_tpu_torch.models.llama import LlamaConfig, Params

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


def expected_shapes(cfg: LlamaConfig) -> dict[str, Any]:
    """The parameter tree's shapes for ``cfg`` (``init_params``' layout)."""
    shapes: dict[str, Any] = {
        "embed": (cfg.vocab_size, cfg.dim),
        "layers": {k: (cfg.n_layers, *f(cfg)) for k, f in _LAYER_SHAPES.items()},
        "final_norm": (cfg.dim,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.dim, cfg.vocab_size)
    return shapes


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
    leaf. The returned leaves require grad for training; serving takes
    ``requires_grad=False`` (the engine refuses leaves that require grad)."""
    if cfg is not None:
        want = expected_shapes(cfg)
        if set(tree) != set(want) or set(tree["layers"]) != set(want["layers"]):
            raise ValueError(
                f"param tree keys {sorted(tree)} / {sorted(tree['layers'])} do not"
                f" match the config's {sorted(want)} (tie_embeddings="
                f"{cfg.tie_embeddings})"
            )
        got = {
            **{k: np.shape(tree[k]) for k in want if k != "layers"},
            "layers": {k: np.shape(v) for k, v in tree["layers"].items()},
        }
        if got != want:
            raise ValueError(f"param shapes {got} do not match the config's {want}")

    def conv(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, device, dtype).requires_grad_(requires_grad)

    return conv(tree)
