"""Ingestion-side fences (watermarks)."""
