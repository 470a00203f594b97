"""Entry points of the port: the eager serving steps and the serve CLI."""
