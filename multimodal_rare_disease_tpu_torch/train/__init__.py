"""Training of the torch package: the host data pipeline, the LR
schedules, the freeze rules, the optimizer state and the Trainer."""
