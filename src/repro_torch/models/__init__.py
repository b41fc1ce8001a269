"""Node-batched paper-scale models."""
