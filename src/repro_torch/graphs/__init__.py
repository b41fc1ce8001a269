"""Complex-network topologies (a numpy copy of the JAX package's
builders)."""
