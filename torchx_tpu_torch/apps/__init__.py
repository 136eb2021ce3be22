"""Entry points of the port: the generation server."""
