"""Tree helpers for nested-dict parameters."""
