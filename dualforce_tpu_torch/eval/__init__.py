"""Evaluation metrics (see metrics.py)."""
