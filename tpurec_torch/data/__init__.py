"""Data utilities of the port (feature hashing)."""
