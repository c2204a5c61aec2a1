"""Batched extract + consecutive-frame match pipeline."""
