"""Vertex programs."""

from .connected_components import ConnectedComponents
from .degree import DegreeBasic
from .diffusion import BinaryDiffusion
from .flow import FlowGraph
from .lpa import LabelPropagation
from .pagerank import PageRank
from .rankings import DegreeRanking, Density, StarNode
from .taint import TaintTracking
from .traversal import BFS, SSSP

__all__ = ["BFS", "SSSP", "BinaryDiffusion", "ConnectedComponents",
           "DegreeBasic", "DegreeRanking", "Density", "FlowGraph",
           "LabelPropagation", "PageRank", "StarNode", "TaintTracking"]
