"""Vertex programs."""

from .pagerank import PageRank

__all__ = ["PageRank"]
