"""How the port is built and driven for each model family."""
