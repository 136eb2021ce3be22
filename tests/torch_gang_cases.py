"""Cases the port's multi-process tests run on every rank of a gloo gang.

Run through the port's bootstrap, which starts the ranks and joins them:

    python -m torchx_tpu_torch.apps.spmd_main --nproc-per-node N --port P \\
        --script tests/torch_gang_cases.py -- job.json

``job.json`` holds ``{"out": dir, "cases": [...]}``; each rank runs the
cases in order and saves ``{case name: result}`` to ``dir/rank<r>.pt``.
Kinds of case:

* ``train``: ``train_llama.train`` on ``--config tiny``'s test shape (dim
  128, 2/1 heads, ffn 256, 2 layers, f32), or the preset ``config``, under
  ``mesh``, from the token file ``data``, with ``ckpt_dir`` and
  ``ckpt_every`` where given, its fields replaced by ``model`` (such as
  ``remat_policy``); -> losses, gradient norms, the final shards, the
  remat policy it ran and ``"auto"``'s trials,
  the shards right after a restore, the checkpoint records, and the error
  it raised (``None``; a case that names ``expect_error`` catches it).
  With ``total_steps`` in place of ``steps``, the case runs to that global
  step: ``total_steps`` less the ``$TPX_RESUME_STEP`` a supervisor's
  resubmission carries (0 without it), which it reports as
  ``resume_step_env``.
  With ``after``, the case first waits for that file (another gang's
  ``done`` marker) and rank 0 copies ``copy_from`` to ``ckpt_dir``; with
  ``done``, rank 0 writes that file once the case has returned (its last
  step committed).
* ``step``: ``make_train_step`` under ``mesh`` on the parameters of
  ``init`` (an ``.npz`` of the JAX tree's leaves by path) and the global
  batches of ``batches`` (``tokens`` [steps, b, s+1], optional
  ``loss_mask``), the model ``llama_tiny(**model)`` (default the test
  shape), or the preset ``config`` with ``model``'s fields replaced;
  -> the same, and each step's router aux vector; under ``pp``, also each
  step's leaves outside the layers (``replicated``: every stage holds
  them whole).
* ``collectives``: the model axes' autograd functions of
  ``parallel/mesh.py`` on a ``tp=2`` and an ``sp=2`` mesh of two ranks,
  forward and backward on inputs seeded by rank (:func:`collective_inputs`);
  -> each function's output and input gradient.
* ``sync``: ``overlap.bucketed_sync`` over the ``dp`` group of a ``dp``
  mesh, on seeded per-rank gradients, with ``bucket_mb`` and with one
  fused sync, gathered in chunks of ``chunk_bytes``; -> both results.
* ``ops``: the long-sequence and pipeline collectives' users under
  ``mesh`` on the whole inputs of ``inputs`` (an ``.npz``):
  ``ring_attention`` or ``ulysses_attention`` (``op`` ``ring`` /
  ``ulysses``) on this rank's positions of ``q``, ``k``, ``v``, or
  ``pipeline_apply`` (``pipeline``, ``pipeline_aux``) of the MLP layer
  ``tanh(x @ w + b)`` on ``x`` with this stage's layers of ``w``, ``b``, in
  ``n_micro`` microbatches; -> the output and, from the backward of the
  sum of its squares (plus the aux for ``pipeline_aux``), the gradients of
  this rank's inputs.
* ``moe_balance``: ``moe.moe_ffn`` on this rank's rows of the batch in
  ``batches`` (``x`` [b, s, d]) and the MoE layer ``init`` (an ``.npz``
  of ``moe_tiny``'s layer-0 leaves) under ``mesh``, its balance term
  averaged over the token group; -> the aux vector.

Not a test module itself: the tests that read the results are
``tests/test_torch_fsdp.py``, ``tests/test_torch_overlap.py``,
``tests/test_torch_gang_ckpt.py``, ``tests/test_torch_moe.py``,
``tests/test_torch_tp.py``, ``tests/test_torch_ep.py``,
``tests/test_torch_ring.py`` and ``tests/test_torch_pp.py``.
"""

import dataclasses
import json
import os
import shutil
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from torchx_tpu_torch.examples import train_llama
from torchx_tpu_torch.models import llama
from torchx_tpu_torch.parallel import overlap
from torchx_tpu_torch.parallel.checkpoint import Checkpointer
from torchx_tpu_torch.parallel.mesh import make_mesh
from torchx_tpu_torch.parallel.mesh_config import parse_mesh_spec

#: The tests' model: llama_tiny at the flash-tileable width of
#: tests/test_torch_model.py.
SHAPE = dict(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256)


def tiny(kernels: str = "cuda") -> llama.LlamaConfig:
    return llama.llama_tiny(kernels=kernels, **SHAPE)


def _capture():
    """-> (boxes, on_state): the final parameter shards, and every entry
    right after a restore."""
    boxes = {"final": {}, "restored": {}}

    def on_state(event, state):  # noqa: ANN001, ANN202
        boxes[event].update({k: v.detach().clone() for k, v in state.items()
                             if event == "restored" or k.startswith("params.")})

    return boxes, on_state


def _wait_and_copy(case: dict) -> None:
    """``after``: wait for that file, then rank 0 copies ``copy_from`` to
    ``ckpt_dir`` while the others wait at a barrier."""
    deadline = time.monotonic() + 180
    while not os.path.exists(case["after"]):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{case['after']} never appeared")
        time.sleep(0.05)
    if dist.get_rank() == 0:
        shutil.copytree(case["copy_from"], case["ckpt_dir"])
    dist.barrier()


def run_train(case: dict) -> dict:
    if "after" in case:
        _wait_and_copy(case)
    boxes, on_state = _capture()
    cfg = llama.get_config(case["config"]) if "config" in case else tiny()
    cfg = dataclasses.replace(cfg, **case.get("model", {}))
    resume_env = Checkpointer.resume_step_from_env()
    steps = case["total_steps"] - (resume_env or 0) if "total_steps" in case else case["steps"]
    try:
        out = train_llama.train(
            cfg, batch=case["batch"], seq=case["seq"], steps=steps,
            warmup=case["warmup"], data_path=case["data"], prefetch=0, kernels="cuda",
            device="cpu", log_every=case.get("log_every", 0), mesh=case["mesh"],
            grad_bucket_mb=case.get("grad_bucket_mb", 0), on_state=on_state,
            ckpt_dir=case.get("ckpt_dir"), ckpt_every=case.get("ckpt_every", 0),
            profile=case.get("profile", False),
        )
    except Exception as e:  # noqa: BLE001 - the case's result
        if not case.get("expect_error"):
            raise
        return {"error": f"{type(e).__name__}: {e}"}
    if "done" in case and dist.get_rank() == 0:
        open(case["done"], "w").close()
    return {"losses": out["losses"], "grad_norms": out["grad_norms"],
            "params": boxes["final"], "restored": boxes["restored"],
            "world": out["world"], "mesh": out["mesh"], "grad_buckets": out["grad_buckets"],
            "resumed_from_step": out["resumed_from_step"], "final_step": out["final_step"],
            "preempted": out["preempted"], "checkpoint": out["checkpoint"],
            "profile": out["profile"], "remat_policy": out["remat_policy"],
            "remat_trials": out["remat_trials"], "resume_step_env": resume_env,
            "error": None}


def run_step(case: dict) -> dict:
    from torchx_tpu_torch import convert

    kernels = case.get("kernels", "cuda")
    if "config" in case:
        cfg = dataclasses.replace(llama.get_config(case["config"]), kernels=kernels,
                                  **case.get("model", {}))
    else:
        cfg = llama.llama_tiny(kernels=kernels, **case.get("model", SHAPE))
    init = np.load(case["init"])
    tree = {}
    for path in init.files:
        node = tree
        *parents, key = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = init[path]
    params = convert.params_from_jax(tree, cfg)
    mesh = make_mesh(parse_mesh_spec(case["mesh"]))
    params = llama.shard_params(params, cfg, mesh)
    counted, norm_group = train_llama.clip_norm_layout(cfg, mesh)
    opt = train_llama.make_optimizer(
        llama.leaves(params), lr=case["lr"], warmup=case["warmup"], counted=counted,
        norm_group=norm_group,
    )
    step = train_llama.make_train_step(cfg, opt, mesh)
    data = np.load(case["batches"])
    rows = mesh.batch_rows(data["tokens"].shape[1])
    losses, norms, auxes, replicated = [], [], [], []
    for i in range(data["tokens"].shape[0]):
        batch = {"tokens": torch.from_numpy(data["tokens"][i][rows])}
        if "loss_mask" in data.files:
            batch["loss_mask"] = torch.from_numpy(data["loss_mask"][i][rows])
        out = step(params, batch)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
        auxes.append(out["aux"].tolist())
        if mesh.sizes["pp"] > 1:
            replicated.append({k: v.detach().clone() for k, v in params.items()
                               if k != "layers"})
    shards = {f"params.{k}": v.detach().clone() for k, v in llama.named_leaves(params)}
    return {"losses": losses, "grad_norms": norms, "auxes": auxes, "params": shards,
            "replicated": replicated}


def run_sync(case: dict) -> dict:
    mesh = make_mesh(parse_mesh_spec(case["mesh"]))
    overlap.GATHER_CHUNK_BYTES = case["chunk_bytes"]
    gen = torch.Generator().manual_seed(1000 + dist.get_rank())
    # leaves of mixed sizes, a bf16 one among them, some above the cap
    shapes = [(3, 5), (1024, 300), (7,), (64, 64), (2048, 129), (11, 13)]
    dtypes = [torch.float32, torch.float32, torch.bfloat16, torch.float32,
              torch.float32, torch.float32]
    grads = [torch.randn(s, generator=gen).to(dt) for s, dt in zip(shapes, dtypes)]
    fused = [g.clone() for g in grads]
    bucketed = [g.clone() for g in grads]
    plan = overlap.plan_buckets(bucketed, case["bucket_mb"] * 1024 * 1024)
    n_fused = overlap.bucketed_sync(fused, None, mesh.dp_group)
    n_bucketed = overlap.bucketed_sync(bucketed, plan, mesh.dp_group)
    return {"local": grads, "fused": fused, "bucketed": bucketed, "n_buckets": plan.n_buckets,
            "issued": [n_fused, n_bucketed]}


def run_ops(case: dict) -> dict:
    from torchx_tpu_torch.ops.ring_attention import ring_attention
    from torchx_tpu_torch.ops.ulysses import ulysses_attention
    from torchx_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = make_mesh(parse_mesh_spec(case["mesh"]))
    data = np.load(case["inputs"])
    op = case["op"]
    if op in ("ring", "ulysses"):
        pos = mesh.positions(data["q"].shape[1])
        args = [torch.from_numpy(data[k][:, pos]).requires_grad_(True) for k in "qkv"]
        fn = ring_attention if op == "ring" else ulysses_attention
        out = fn(*args, mesh)
        loss = (out**2).sum()
    else:
        n = mesh.sizes["pp"]
        layers = [torch.from_numpy(data[k]).chunk(n)[mesh.stage].clone().requires_grad_(True)
                  for k in ("w", "b")]
        args = [torch.from_numpy(data["x"]).requires_grad_(True), *layers]
        with_aux = op == "pipeline_aux"

        def body(h, weights):  # noqa: ANN001, ANN202
            y = torch.tanh(h @ weights[0] + weights[1])
            return (y, h.mean()) if with_aux else y

        res = pipeline_apply(body, layers, args[0], mesh, case["n_micro"], with_aux=with_aux)
        out, aux = res if with_aux else (res, None)
        loss = (out**2).sum() + (aux.sum() if with_aux else 0)
    loss.backward()
    return {"out": out.detach(), "aux": None if op != "pipeline_aux" else aux.detach(),
            "grads": [a.grad for a in args]}


def run_moe_balance(case: dict) -> dict:
    from torchx_tpu_torch.models import moe

    cfg = moe.moe_tiny()
    init = np.load(case["init"])
    layer = {k: torch.from_numpy(init[k]) for k in init.files}
    x = np.load(case["batches"])["x"]
    mesh = make_mesh(parse_mesh_spec(case["mesh"]))
    rows = mesh.batch_rows(x.shape[0])
    _, aux = moe.moe_ffn(cfg, layer, torch.from_numpy(x[rows]), mesh)
    return {"aux": aux}


def collective_inputs(rank: int) -> dict:
    """The ``collectives`` case's inputs on ``rank``: ``x`` and its upstream
    gradient ``g`` per rank (``[4, 6, 3]``), and ``whole`` / ``g_block``,
    a tensor every rank holds and the gradient of a rank's block of it."""
    gen = torch.Generator().manual_seed(2000 + rank)
    same = torch.Generator().manual_seed(1999)
    return {"x": torch.randn(4, 6, 3, generator=gen),
            "g": torch.randn(4, 6, 3, generator=gen),
            "g_whole": torch.randn(4, 12, 3, generator=gen),
            "g_block": torch.randn(4, 3, 3, generator=gen),
            "whole": torch.randn(4, 6, 3, generator=same)}


def run_collectives(case: dict) -> dict:
    from torchx_tpu_torch.parallel import mesh as m

    inp = collective_inputs(dist.get_rank())
    # name -> (mesh, call, input, upstream gradient; None: no backward)
    calls = {
        "copy_to_tp": ("tp=2", lambda x, mesh: m.copy_to_tp(x, mesh), "x", "g"),
        "reduce_from_tp": ("tp=2", lambda x, mesh: m.reduce_from_tp(x, mesh), "x", "g"),
        "tp_block": ("tp=2", lambda x, mesh: m.tp_block(x, 1, mesh), "whole", "g_block"),
        "max_over_tp": ("tp=2", lambda x, mesh: m.max_over_tp(x, mesh), "x", None),
        "gather_sequence": ("sp=2", lambda x, mesh: m.gather_sequence(x, 1, mesh), "x",
                            "g_whole"),
        "sequence_block": ("sp=2", lambda x, mesh: m.sequence_block(x, 1, mesh), "whole",
                           "g_block"),
    }
    meshes = {spec: make_mesh(parse_mesh_spec(spec)) for spec in ("tp=2", "sp=2")}
    out = {}
    for name, (spec, call, x_key, g_key) in calls.items():
        x = inp[x_key].clone().requires_grad_(True)
        y = call(x, meshes[spec])
        if g_key is not None:
            y.backward(inp[g_key])
        out[name] = {"y": y.detach(), "grad": x.grad}
    return out


RUNNERS = {"train": run_train, "step": run_step, "sync": run_sync,
           "moe_balance": run_moe_balance, "collectives": run_collectives, "ops": run_ops}


def main() -> None:
    job = json.load(open(sys.argv[1]))
    results = {case["name"]: RUNNERS[case["kind"]](case) for case in job["cases"]}
    torch.save(results, os.path.join(job["out"], f"rank{dist.get_rank()}.pt"))


# -- the launcher side, for the tests ----------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(argv: list, env: dict = None):  # noqa: ANN201
    """``python -m torchx_tpu_torch.apps.spmd_main *argv`` in a session of
    its own (so that its workers can be killed with it), the repo on
    ``PYTHONPATH``, one intra-op thread a process."""
    import subprocess

    full = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **(env or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "torchx_tpu_torch.apps.spmd_main", *argv],
        cwd=REPO, env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )


def finish(procs: list, timeout: float = 240.0) -> list:
    """Wait for every process of ``procs`` under one deadline; past it, kill
    each one's whole session (its workers too). -> [(rc, out, err)], rc
    None for a killed one."""
    import signal
    import subprocess
    import time

    deadline = time.monotonic() + timeout
    res = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
            res.append((p.returncode, out, err))
        except subprocess.TimeoutExpired:
            res.append((None, "", "timed out"))
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except OSError:
            pass
        if p.poll() is None:
            p.communicate()
    return res


def finish_replicas(launch, timeout: float = 240.0, attempts: int = 3) -> list:
    """:func:`finish` of ``launch(port)``'s processes, the replicas of one
    gang on a port from :func:`free_port`, launched again on a fresh port
    when a replica's stderr names ``EADDRINUSE`` (another process took the
    port between its choice and its bind), at most ``attempts`` times."""
    for attempt in range(attempts):
        res = finish(launch(free_port()), timeout)
        if attempt == attempts - 1 or not any("EADDRINUSE" in err for _, _, err in res):
            return res
    return res


def run_cases(tmp, nproc: int, cases: list, env: dict = None):  # noqa: ANN001, ANN201
    """Start a gang of ``nproc`` ranks on ``cases`` (``env`` added to the
    environment); -> the Popen (read it with :func:`finish`, then
    :func:`load_results`)."""
    out = os.path.join(str(tmp), f"out{nproc}")
    os.makedirs(out, exist_ok=True)
    job = os.path.join(str(tmp), f"job{nproc}.json")
    with open(job, "w") as f:
        json.dump({"out": out, "cases": cases}, f)
    return start(["--nproc-per-node", str(nproc), "--port", "0",
                  "--timeout", "60", "--script", os.path.join(REPO, "tests",
                                                              "torch_gang_cases.py"),
                  "--", job], env)


def load_results(tmp, nproc: int) -> list:  # noqa: ANN001
    out = os.path.join(str(tmp), f"out{nproc}")
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(nproc)]


if __name__ == "__main__":
    main()
