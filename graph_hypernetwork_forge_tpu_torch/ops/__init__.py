"""Tensor operations of the port."""
