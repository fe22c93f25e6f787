"""Model-level accounting (:mod:`.analysis`): parameter counts and model
FLOPs.  The reference's HLO-based roofline has no counterpart here."""
