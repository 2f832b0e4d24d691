"""Runtime analysis hooks of the port (the sanitizer's entry points)."""
