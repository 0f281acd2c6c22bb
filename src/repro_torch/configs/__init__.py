"""Model configurations of the port (no registry: import the module)."""
