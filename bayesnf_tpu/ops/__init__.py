"""Precision-controlled matmuls and numerical primitives."""
