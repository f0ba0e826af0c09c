"""Search engine and HTTP server of the port."""
