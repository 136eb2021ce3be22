"""Host-side input prefetch and checkpoints."""
