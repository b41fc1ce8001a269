"""Local training, evaluation and per-round metrics."""
