"""Comparison: all-pairs counts and similarity epilogues."""
