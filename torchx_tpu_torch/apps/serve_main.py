"""Model-serving registration client.

Port of :mod:`torchx_tpu.apps.serve_main`.
Reference analog: torchx/apps/serve/serve.py — registers a trained model
archive with a model server's management API (the reference targets
TorchServe; the protocol here is a plain HTTP management endpoint so any
registry-style server works, e.g. a JetStream/vLLM-router sidecar or an
internal registry).

    python -m torchx_tpu_torch.apps.serve_main \
        --model_path gs://bucket/ckpts/llama3-8b/500 \
        --management_api http://server:8081 \
        --model_name llama3-8b

Exits non-zero (and writes the structured error file) if registration is
rejected.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.parse
import urllib.request


def register_model(
    management_api: str,
    model_path: str,
    model_name: str,
    timeout: float = 60.0,
    params: dict[str, str] | None = None,
) -> dict:
    query = {"url": model_path, "model_name": model_name, **(params or {})}
    url = (
        management_api.rstrip("/")
        + "/models?"
        + urllib.parse.urlencode(query)
    )
    req = urllib.request.Request(url, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read().decode()
        try:
            return json.loads(body)
        except json.JSONDecodeError:
            return {"status": body, "code": resp.status}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--management_api", required=True)
    parser.add_argument("--model_name", required=True)
    parser.add_argument("--timeout", type=float, default=60.0)
    parser.add_argument(
        "--params", default=None, help="extra query params k=v,k2=v2"
    )
    args = parser.parse_args(argv)
    params = None
    if args.params:
        params = {}
        for pair in args.params.split(","):
            if "=" not in pair:
                parser.error(f"--params entry {pair!r} must be k=v")
            k, _, v = pair.partition("=")
            params[k] = v
    try:
        result = register_model(
            args.management_api,
            args.model_path,
            args.model_name,
            timeout=args.timeout,
            params=params,
        )
    except Exception as e:  # noqa: BLE001
        print(f"model registration failed: {e}", file=sys.stderr)
        from torchx_tpu_torch.apps.spmd_main import write_error_file

        write_error_file(e)
        sys.exit(1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
