"""Comparator, cost models, timing, printing and CSV reports."""
