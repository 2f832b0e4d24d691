"""Host utilities: device resolution and synthetic workloads."""
