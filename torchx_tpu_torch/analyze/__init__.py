"""The analyzer's cost model, as far as the port needs it (the data axes'
collective bytes, for the step profiler)."""
