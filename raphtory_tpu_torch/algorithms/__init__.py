"""Vertex programs."""

from .connected_components import ConnectedComponents
from .degree import DegreeBasic
from .pagerank import PageRank
from .traversal import BFS, SSSP

__all__ = ["BFS", "SSSP", "ConnectedComponents", "DegreeBasic", "PageRank"]
