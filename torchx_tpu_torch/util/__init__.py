"""The launcher's stdlib-only helpers, copied from :mod:`torchx_tpu.util`
(all but ``log_tee_helpers``, which needs the runner): strings, colors,
file IO, dynamic imports, entry points, typed CLI decoding, clocks and time
windows, durable JSONL, key/value registry files and the session id.

No module here imports ``torch``: a launcher process loads no CUDA.
"""
