"""Algorithm 1 of the port: BFS, edge classes, the intersection engine."""
