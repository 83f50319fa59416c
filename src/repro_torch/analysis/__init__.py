"""Index-dtype policy of the port (counterpart of ``repro.analysis``)."""
