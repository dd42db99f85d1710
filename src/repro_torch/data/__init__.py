"""Sparse matrix generators (numpy/scipy, no device state)."""
