"""Complex-network topologies (a numpy copy of the JAX package's
builders): the dense padded layout and the sparse CSR edge list."""
from repro_torch.graphs.sparse import (  # noqa: F401
    SPARSE_BUILDERS,
    SparseTopology,
    make_sparse_topology,
    rev_edge_permutation,
    undirected_pair_ids,
)
from repro_torch.graphs.topology import (  # noqa: F401
    TOPOLOGY_BUILDERS,
    Topology,
    make_topology,
)
