"""Training substrate of the LM harness: optimizers, train / prefill /
serve steps, checkpoints and fault tolerance (the port of ``repro.train``)."""
