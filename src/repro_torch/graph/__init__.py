"""Graph substrate of the port: CSR container and generators."""
