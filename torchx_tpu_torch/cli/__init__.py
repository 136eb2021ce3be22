"""The ``tpx-torch`` command line: the port of :mod:`torchx_tpu.cli`."""
