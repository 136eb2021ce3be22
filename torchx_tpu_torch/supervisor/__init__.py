"""The in-job half of gang supervision: per-replica liveness leases."""
