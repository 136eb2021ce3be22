"""Host-side input prefetch."""
