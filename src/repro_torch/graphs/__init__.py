"""Complex-network topologies (a numpy copy of the JAX package's
builders): the dense padded layout, the sparse CSR edge list, and the
partition of a graph onto pods."""
from repro_torch.graphs.partition import (  # noqa: F401
    map_graph_to_pods,
    pod_adjacency,
)
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
