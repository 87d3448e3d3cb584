"""Registry, checkpoint conversion and device selection."""
