"""Datasets, non-IID allocation and minibatching (numpy copies of the JAX
package's data builders, plus the node-batched torch Batcher)."""
