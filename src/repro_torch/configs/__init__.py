"""Architecture configs of the port (``registry.arch_module``)."""
