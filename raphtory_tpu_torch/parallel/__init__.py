"""The mesh path: vertex-sharded supersteps (``sharded``), the sparse
frontier route (``frontier``), the static-partition range sweep
(``sweep``) and column-sharded Range sweeps (``columns``), over the ranks
of a ``torch.distributed`` process group."""
