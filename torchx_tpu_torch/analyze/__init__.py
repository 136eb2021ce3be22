"""The analyzer, as far as the port needs it: the cost model's terms
(the data axes' collective bytes, for the step profiler) and which roles
are plan-shaped (:mod:`~torchx_tpu_torch.analyze.plan`, for the fleet
placer's oracle seam)."""
