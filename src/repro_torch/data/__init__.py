"""The LM data pipeline (:mod:`.pipeline`): seeded synthetic or file
token batches, keyed by (step, host), and host->device prefetch."""
