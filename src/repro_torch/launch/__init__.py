"""Entry points of the port: the serving CLI and its engine."""
