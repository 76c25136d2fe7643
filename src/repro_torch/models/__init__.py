"""Models of the port: the dense decoder-only LM."""
