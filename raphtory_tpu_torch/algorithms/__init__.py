"""Vertex programs."""

from .connected_components import ConnectedComponents
from .pagerank import PageRank
from .traversal import BFS, SSSP

__all__ = ["BFS", "SSSP", "ConnectedComponents", "PageRank"]
