"""Vertex programs."""

from .connected_components import ConnectedComponents
from .degree import DegreeBasic
from .lpa import LabelPropagation
from .pagerank import PageRank
from .taint import TaintTracking
from .traversal import BFS, SSSP

__all__ = ["BFS", "SSSP", "ConnectedComponents", "DegreeBasic",
           "LabelPropagation", "PageRank", "TaintTracking"]
