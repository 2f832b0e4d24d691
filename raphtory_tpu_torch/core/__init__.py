"""Temporal store: event log, snapshot folds, incremental sweep, service."""
