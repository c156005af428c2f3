"""Layers of the port (counterpart of ``tpurec/nn``)."""
