"""Optimizers over nested-dict parameter trees."""
