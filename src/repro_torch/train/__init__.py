"""Training, on one card or sharded over a mesh: the torch counterpart of
``repro.train`` (AdamW, synthetic data, watchdog, checkpoints, the trainer
and the Lit Silicon co-simulation hook)."""
