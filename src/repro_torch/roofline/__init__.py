"""Model-level accounting (:mod:`.analysis`): parameter counts, model
FLOPs, and the dry run's roofline terms counted from the ops a rank
dispatches (``OpCounter``, ``RooflineTerms``)."""
