"""Calibration statistics, model-level sparsification and perplexity."""
