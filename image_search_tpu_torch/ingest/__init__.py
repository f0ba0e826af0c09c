"""Scan pipeline of the port: decode pool and walk -> decode -> embed -> index."""
