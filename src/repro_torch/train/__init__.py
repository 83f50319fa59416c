"""The port's training stack: optimizers, checkpoints and the trainer
(counterparts of ``repro.train``)."""
